# SPDX-License-Identifier: Apache-2.0
"""``dftd3`` and the window engine's virial of the PyTorch port against the
JAX package, on the CPU.

Inputs are made from a seed with numpy; both packages get the same
neighbour structures, built with the JAX package's naive neighbour lists
and carried across as numpy.  f64 results are held at 1e-10 of their
scale, f32 within 1.25x the JAX package's own f32 error against its f64
result.  The JAX ``dftd3`` compiles once per shape, format, number of
systems and virial flag, so the cases share a few systems and cache the
JAX results.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch.interactions.dispersion import _kernels as tk
from nvalchemiops_torch.interactions.dispersion import D3Parameters, dftd3
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_tpu.interactions.dispersion import D3Parameters as JParams
from nvalchemiops_tpu.interactions.dispersion import dftd3 as jdftd3
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_tpu.grid import build_atom_grid, estimate_grid_geometry
from nvalchemiops_tpu.neighborlist import (
    batch_naive_neighbor_list, get_neighbor_list_from_neighbor_matrix,
    naive_neighbor_list,
)
from nvalchemiops_tpu.neighborlist.neighbor_utils import shifts_from_aos

from tests._torch_port import assert_close, port_grid

RTOL = 1e-10
A1, A2, S8 = 0.42, 4.1, 1.7
N_ATOMS, CUTOFF, K = 48, 5.0, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed=21, zmax=4):
    """Random D3 tables of the reference's shapes: some C6 references
    zero (as in real tables), CN references per element pair."""
    rng = np.random.default_rng(seed)
    rcov = np.r_[0.0, rng.uniform(0.6, 1.4, zmax)]
    r4r2 = np.r_[0.0, rng.uniform(2.0, 6.0, zmax)]
    c6 = np.zeros((zmax + 1, zmax + 1, 5, 5))
    cn_ref = np.zeros_like(c6)
    for zi in range(1, zmax + 1):
        for zj in range(1, zmax + 1):
            c = rng.uniform(5.0, 40.0, (5, 5))
            c[rng.random((5, 5)) < 0.3] = 0.0
            c6[zi, zj] = c
            cn_ref[zi, zj] = np.cumsum(rng.uniform(0.3, 1.0, (5, 5)), 0)
    # the pair convention c6ab[zi, zj, p, q] == c6ab[zj, zi, q, p]
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, c6, cn_ref


TABLES = _tables()


def _cells(kind):
    if kind == "open":
        return None
    if kind == "cubic":
        return np.eye(3) * 8.5
    return np.array([[8.5, 0.0, 0.0], [1.3, 8.2, 0.0], [-0.9, 1.1, 8.8]])


def _system(kind, seed=22):
    """``N_ATOMS`` atoms (one padding atom) in ``kind``'s cell, or a
    cluster when open; positions, numbers, cell."""
    rng = np.random.default_rng(seed)
    cell = _cells(kind)
    frac = rng.uniform(0, 1, (N_ATOMS, 3))
    pos = frac @ (cell if cell is not None else np.eye(3) * 8.5)
    numbers = rng.integers(1, 5, N_ATOMS).astype(np.int32)
    numbers[5] = 0
    return pos, numbers, cell


@functools.lru_cache(maxsize=None)
def _structures(kind):
    """The JAX naive neighbour matrix of ``kind`` (``"open"``, ``"cubic"``,
    ``"triclinic"``, ``"batch"``: two triclinic systems of ``N_ATOMS / 2``
    atoms with their own cells) and its COO list, as numpy, with the
    positions, numbers, cell and batch_idx."""
    if kind == "batch":
        pos, numbers, cell = _system("triclinic")
        half = N_ATOMS // 2
        cells = np.stack([cell, cell * 1.1])
        pos = np.concatenate([pos[:half], pos[half:] * 1.1])
        bidx = np.repeat(np.arange(2), half).astype(np.int32)
        nm, num, sh = batch_naive_neighbor_list(
            jnp.asarray(pos), CUTOFF, pbc=np.ones((2, 3), bool),
            cell=jnp.asarray(cells), batch_idx=jnp.asarray(bidx),
            max_neighbors=K)
        cell = cells
    else:
        pos, numbers, cell = _system(kind)
        bidx = None
        if cell is None:
            nm, num = naive_neighbor_list(jnp.asarray(pos), CUTOFF,
                                          max_neighbors=K)
            sh = None
        else:
            nm, num, sh = naive_neighbor_list(
                jnp.asarray(pos), CUTOFF, pbc=np.array([True] * 3),
                cell=jnp.asarray(cell), max_neighbors=K)
    assert int(np.asarray(num).max()) < K
    coo = get_neighbor_list_from_neighbor_matrix(
        nm, num, sh, fill_value=N_ATOMS)
    listed = dict(neighbor_list=np.array(coo[0]),
                  neighbor_ptr=np.array(coo[1]))
    if sh is not None:
        listed["unit_shifts"] = np.array(coo[2])
    matrix = dict(neighbor_matrix=np.array(nm))
    if sh is not None:
        matrix["neighbor_matrix_shifts"] = np.array(sh)
    return pos, numbers, cell, bidx, matrix, listed


def _args(kind, fmt, dtype=np.float64, shared_cell=False):
    """Positional and keyword inputs of ``kind`` / ``fmt`` as numpy."""
    pos, numbers, cell, bidx, matrix, listed = _structures(kind)
    kw = dict(matrix if fmt == "matrix" else listed)
    if cell is not None:
        kw["cell"] = (cell[0] if shared_cell else cell).astype(dtype)
        kw["compute_virial"] = True
    if bidx is not None:
        kw["batch_idx"] = bidx
    return pos.astype(dtype), numbers, kw


def _port(pos, numbers, kw, **extra):
    t = {k: (v if isinstance(v, bool) else torch.as_tensor(v))
         for k, v in kw.items()}
    return dftd3(torch.as_tensor(pos), numbers, A1, A2, S8,
                 d3_params=D3Parameters(*TABLES, device="cpu"),
                 output_dtype=None, **t, **extra)


def _jax(pos, numbers, kw, **extra):
    j = {k: (v if isinstance(v, bool) else jnp.asarray(v))
         for k, v in kw.items()}
    out = jdftd3(jnp.asarray(pos), jnp.asarray(numbers), A1, A2, S8,
                 d3_params=JParams(*TABLES), output_dtype=None, **j, **extra)
    return tuple(np.asarray(x) for x in out)


@functools.lru_cache(maxsize=None)
def _jax_ref(kind, fmt, dtype=np.float64, shared_cell=False):
    return _jax(*_args(kind, fmt, dtype, shared_cell))


def _close(out, ref, rtol=RTOL):
    assert len(out) == len(ref)
    for a, r in zip(out, ref):
        assert tuple(a.shape) == tuple(r.shape)
        assert_close(a, r, rtol=rtol)


# ---------------------------------------------------------------------------
# dftd3 against the JAX package, f64
# ---------------------------------------------------------------------------


CASES = [("open", "matrix"), ("cubic", "matrix"), ("triclinic", "matrix"),
         ("batch", "matrix"), ("open", "list"), ("triclinic", "list"),
         ("batch", "list")]


@pytest.mark.parametrize("kind,fmt", CASES)
def test_dftd3_matches_jax(kind, fmt):
    """Energies, forces, CNs (and the virial where there is a cell) at
    1e-10 of scale: no PBC, cubic and triclinic cells, and two systems
    under ``batch_idx`` with a cell each; one padding atom in each.  The
    triclinic list is held to the JAX list result; the other lists to the
    JAX matrix result on the same pairs (the two JAX paths agree to f64
    rounding, and each JAX list shape is one more compile)."""
    ref_fmt = fmt if kind == "triclinic" else "matrix"
    _close(_port(*_args(kind, fmt)), _jax_ref(kind, ref_fmt))


@pytest.mark.parametrize("fmt", ["matrix", "list"])
def test_packed_shifts_match_jax(fmt):
    """Bit-packed shifts (``[N, K]`` matrix, ``[P]`` list) give the JAX
    result of the ``[.., 3]`` ones."""
    pos, numbers, kw = _args("triclinic", fmt)
    key = "neighbor_matrix_shifts" if fmt == "matrix" else "unit_shifts"
    kw[key] = np.array(shifts_from_aos(jnp.asarray(kw[key])))
    assert kw[key].ndim == (2 if fmt == "matrix" else 1)
    _close(_port(pos, numbers, kw), _jax_ref("triclinic", fmt))


def test_batch_with_one_shared_cell_matches_jax():
    """``batch_idx`` with one ``[3, 3]`` cell for both systems:
    ``num_systems`` read from ``batch_idx``."""
    args = _args("batch", "matrix", shared_cell=True)
    out = _port(*args)
    assert out[0].shape == (2,) and out[3].shape == (2, 3, 3)
    _close(out, _jax_ref("batch", "matrix", shared_cell=True))


@pytest.mark.parametrize("fmt", ["matrix", "list"])
def test_s5_window_matches_jax(fmt):
    """The S5 switching window inside the pair range."""
    win = dict(s5_smoothing_on=3.0, s5_smoothing_off=4.5)
    pos, numbers, kw = _args("triclinic", fmt)
    out = _port(pos, numbers, kw, **win)
    _close(out, _jax(pos, numbers, kw, **win))
    assert not np.array_equal(out[0].numpy(), _jax_ref("triclinic", fmt)[0])


@pytest.mark.parametrize("fmt", ["matrix", "list"])
def test_f32_within_jax_own_f32_error(fmt):
    """f32 forces (max and RMS relative error): the port's error against
    the JAX f64 result is at most 1.25x the JAX package's own f32 error.
    Energies and the virial, single sums whose f32 rounding moves from
    system to system in both packages (either package ahead by up to ~2x),
    are held at 1e-6 and 1e-5 of scale against the JAX f64 result."""
    ref = _jax_ref("triclinic", fmt)
    jax32 = _jax_ref("triclinic", fmt, np.float32)
    out = _port(*_args("triclinic", fmt, np.float32))
    assert out[1].dtype == torch.float32

    def errors(got, want):
        got = np.asarray(got, np.float64)
        return (np.abs(got - want).max() / np.abs(want).max(),
                np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))

    port_err = errors(out[1].numpy(), ref[1])
    jax_err = errors(jax32[1], ref[1])
    assert all(p <= 1.25 * j for p, j in zip(port_err, jax_err)), (
        port_err, jax_err)
    assert errors(out[0].numpy(), ref[0])[0] <= 1e-6
    assert errors(out[3].numpy(), ref[3])[0] <= 1e-5


@pytest.mark.parametrize("fmt", ["matrix", "list"])
def test_empty_system_returns_zeros(fmt):
    kw = (dict(neighbor_matrix=np.zeros((0, 4), np.int32),
               neighbor_matrix_shifts=np.zeros((0, 4, 3), np.int32))
          if fmt == "matrix" else
          dict(neighbor_list=np.zeros((2, 0), np.int32),
               neighbor_ptr=np.zeros(1, np.int32),
               unit_shifts=np.zeros((0, 3), np.int32)))
    kw.update(cell=np.eye(3) * 5.0, compute_virial=True)
    pos, numbers = np.zeros((0, 3)), np.zeros(0, np.int32)
    out = _port(pos, numbers, kw)
    ref = _jax(pos, numbers, kw)
    assert [tuple(o.shape) for o in out] == [(1,), (0, 3), (0,), (1, 3, 3)]
    _close(out, ref)
    assert all(not o.any() for o in out)


def test_parameters_as_dataclass_dict_or_arrays_agree():
    """``D3Parameters``, a dict and the explicit tables (overriding a
    dict's) give the same bits."""
    pos, numbers, kw = _args("triclinic", "matrix")
    t = {k: (v if isinstance(v, bool) else torch.as_tensor(v))
         for k, v in kw.items()}
    base = _port(pos, numbers, kw)
    params = D3Parameters(*TABLES, device="cpu")
    names = ("covalent_radii", "r4r2", "c6_reference", "coord_num_ref")
    for extra in (dict(d3_params=params.as_dict()),
                  dict(zip(names, TABLES)),
                  dict(d3_params={"rcov": TABLES[0] * 3.0},
                       **dict(zip(names, TABLES)))):
        out = dftd3(torch.as_tensor(pos), numbers, A1, A2, S8,
                    output_dtype=None, **t, **extra)
        for a, b in zip(out, base):
            assert torch.equal(a, b)


def _bad_calls():
    pos, numbers, kw = _args("triclinic", "matrix")
    _, _, kl = _args("triclinic", "list")
    tables = dict(zip(("rcov", "r4r2", "c6ab", "cn_ref"), TABLES))
    no_cell = {k: v for k, v in kw.items() if k not in ("cell",
                                                        "compute_virial")}

    def call(**k):
        return pos, numbers, k

    return {
        "both formats": call(**kw, neighbor_list=kl["neighbor_list"]),
        "no format": call(cell=kw["cell"]),
        "virial without cell": call(**no_cell, compute_virial=True),
        "matrix without shifts": call(
            neighbor_matrix=kw["neighbor_matrix"], cell=kw["cell"]),
        "list without shifts": call(neighbor_list=kl["neighbor_list"],
                                    cell=kw["cell"]),
        "no tables": call(**kw, d3_params=None),
        "a table missing": call(**kw, d3_params={
            k: v for k, v in tables.items() if k != "cn_ref"}),
        "rcov 2-D": ("D3Parameters", dict(tables, rcov=tables["rcov"][:,
                                                                      None])),
        "r4r2 short": ("D3Parameters", dict(tables,
                                            r4r2=tables["r4r2"][:-1])),
        "c6ab shape": ("D3Parameters", dict(tables,
                                            c6ab=tables["c6ab"][:, :-1])),
        "cn_ref shape": ("D3Parameters", dict(
            tables, cn_ref=tables["cn_ref"][..., :4])),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_bad_inputs_raise_value_error_as_in_jax(case):
    """Each raises ``ValueError`` in both packages."""
    first, second, *rest = _bad_calls()[case]
    if isinstance(first, str):
        with pytest.raises(ValueError):
            D3Parameters(**second, device="cpu")
        with pytest.raises(ValueError):
            JParams(**second)
        return
    kw = rest[0]
    given = {} if "d3_params" in kw else {"d3_params": JParams(*TABLES)}
    with pytest.raises(ValueError):
        jdftd3(jnp.asarray(first), jnp.asarray(second), A1, A2, S8,
               **{k: (v if isinstance(v, (bool, dict)) or v is None
                      else jnp.asarray(v)) for k, v in kw.items()}, **given)
    if "d3_params" not in kw:
        kw = dict(kw, d3_params=D3Parameters(*TABLES, device="cpu"))
    with pytest.raises(ValueError):
        dftd3(torch.as_tensor(first), second, A1, A2, S8, **kw)


@pytest.mark.parametrize("dtype", [None, torch.float32, jnp.float32,
                                   np.float32, "float32", "float64"])
def test_output_dtype_takes_torch_numpy_and_jax_dtypes(dtype):
    """``output_dtype``: a torch dtype, a numpy/JAX dtype or its name; the
    default is f32, None keeps the positions' dtype."""
    pos, numbers, kw = _args("triclinic", "matrix")
    kw.pop("compute_virial")
    t = {k: torch.as_tensor(v) for k, v in kw.items()}
    out = dftd3(torch.as_tensor(pos), numbers, A1, A2, S8,
                d3_params=D3Parameters(*TABLES, device="cpu"),
                output_dtype=dtype, **t)
    want = torch.float64 if dtype in (None, "float64") else torch.float32
    assert all(o.dtype == want for o in out)
    default = dftd3(torch.as_tensor(pos), numbers, A1, A2, S8,
                    d3_params=D3Parameters(*TABLES, device="cpu"), **t)
    assert all(o.dtype == torch.float32 for o in default)
    with pytest.raises(ValueError, match="output_dtype"):
        dftd3(torch.as_tensor(pos), numbers, A1, A2, S8,
              d3_params=D3Parameters(*TABLES, device="cpu"),
              output_dtype="int32", **t)


# ---------------------------------------------------------------------------
# The virial against the strain derivative; chunk sizes
# ---------------------------------------------------------------------------


def test_virial_is_minus_the_strain_derivative_of_the_energy():
    """``virial = -dE/d(strain)`` by central differences in f64, on a fixed
    pair list (positions and cell strained together)."""
    pos, numbers, kw = _args("triclinic", "matrix")
    cell = kw["cell"]
    virial = _port(pos, numbers, kw)[3][0].numpy()

    def energy(eps):
        strain = np.eye(3) + eps
        k = dict(kw, cell=cell @ strain.T, compute_virial=False)
        return float(_port(pos @ strain.T, numbers, k)[0][0])

    h = 1e-6
    for a, b in ((0, 0), (1, 1), (0, 1), (2, 0), (1, 2)):
        eps = np.zeros((3, 3))
        eps[a, b] = h
        fd = (energy(eps) - energy(-eps)) / (2 * h)
        assert abs(-virial[a, b] - fd) <= 1e-6 * np.abs(virial).max(), (
            a, b, virial[a, b], fd)


@pytest.mark.parametrize("fmt,chunk", [("matrix", 3 * K), ("matrix", 7),
                                       ("list", 50), ("list", 7)])
def test_chunk_sizes_agree(fmt, chunk, monkeypatch):
    """Chunks of ``chunk`` pair slots against one chunk: cutting the
    matrix's rows only gives the same bits; cutting columns or the list
    agrees to 1e-12."""
    args = _args("batch", fmt)
    whole = _port(*args)
    monkeypatch.setattr(tk, "D3_PAIR_CHUNK", chunk)
    out = _port(*args)
    for a, b in zip(out, whole):
        if fmt == "matrix" and chunk % K == 0:
            assert torch.equal(a, b)
        else:
            assert_close(a, b, rtol=1e-12)
    assert len(tk._row_chunks(np.full(N_ATOMS, K), chunk)) > 1


# ---------------------------------------------------------------------------
# The window engine's virial
# ---------------------------------------------------------------------------


def _grid_case(kind):
    """tests/test_grid.py's 150-atom virial system (cubic, 11 A) or the
    same draws in a triclinic cell; element-structured tables."""
    rng = np.random.default_rng(13)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    cn_ref = np.broadcast_to(cna[:, None, :, None],
                             (zmax + 1,) * 2 + (5, 5)).copy()
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cell = np.eye(3) * 11.0
    if kind == "triclinic":
        cell = np.array([[11.0, 0.0, 0.0], [1.5, 11.0, 0.0],
                         [-1.0, 1.0, 11.0]])
    pos = rng.uniform(0, 11.0, (150, 3)) @ (cell / 11.0)
    numbers = rng.integers(1, zmax + 1, 150).astype(np.int32)
    return pos, numbers, cell, (rcov, r4r2, c6, cn_ref, cna)


@functools.lru_cache(maxsize=None)
def _window_case(kind):
    """The JAX grid (xla engine) and matrix references of ``kind``."""
    pos, numbers, cell, (rcov, r4r2, c6, cn_ref, cna) = _grid_case(kind)
    pbc = np.array([True] * 3)
    cutoff = 3.4
    nm, _, sh = naive_neighbor_list(jnp.asarray(pos), cutoff, pbc=pbc,
                                    cell=jnp.asarray(cell), max_neighbors=48)
    mat = jdftd3(jnp.asarray(pos), jnp.asarray(numbers), A1, A2, S8,
                 d3_params=JParams(rcov, r4r2, c6, cn_ref),
                 cell=jnp.asarray(cell), neighbor_matrix=nm,
                 neighbor_matrix_shifts=sh, output_dtype=None,
                 compute_virial=True)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff, 150,
                                               target_occupancy=0.4)
    g = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims,
                        radius, cap)
    grid = jd3.grid_dftd3(g, jnp.asarray(numbers), *(jnp.asarray(t) for t in
                                                      (rcov, r4r2, c6, cna)),
                          cutoff, A1, A2, S8, compute_virial=True,
                          cell=jnp.asarray(cell))
    return g, ([np.asarray(x) for x in mat],
               [np.asarray(x) for x in grid])


@pytest.mark.parametrize("kind", ["cubic", "triclinic"])
def test_window_virial_matches_jax(kind):
    """``grid_dftd3(compute_virial=True, cell=...)`` on the window engine
    (kernel 1's plain version here) against the JAX ``dftd3`` matrix
    virial and its ``grid_dftd3`` virial (XLA engine) at 1e-10; energy and
    forces too."""
    pos, numbers, cell, (rcov, r4r2, c6, _, cna) = _grid_case(kind)
    g, (mat, grid) = _window_case(kind)
    e, f, cn, vir = td3.grid_dftd3(port_grid(g), numbers, rcov, r4r2, c6,
                                   cna, 3.4, A1, A2, S8, compute_virial=True,
                                   cell=torch.as_tensor(cell))
    assert vir.shape == (3, 3)
    for ref in (mat[3].reshape(3, 3), grid[3]):
        assert_close(vir, ref, rtol=RTOL)
    assert_close(e, mat[0].sum(), rtol=RTOL)
    assert_close(f, mat[1], rtol=RTOL)
    assert_close(cn, grid[2], rtol=RTOL)


@pytest.mark.parametrize("call", ["no cell", "engine block", "engine pallas",
                                  "stencil"])
def test_window_virial_fallbacks_raise_naming_roadmap(call):
    """Where the JAX package takes its XLA engine's virial (no cell, the
    block or pallas engine, a stencil), the port takes the window engine's
    with no stencil (it raised ``NotImplementedError`` before the XLA
    engine's virial was covered; the name is kept): JAX's energy, forces,
    CNs and virial, and with a cell the bits of the window engine's call,
    the ghost shifts then coming from the cell."""
    from nvalchemiops_torch import stencil as tst

    pos, numbers, cell, (rcov, r4r2, c6, _, cna) = _grid_case("cubic")
    g, (_, grid) = _window_case("cubic")
    kw = dict(compute_virial=True, cell=cell)
    if call == "no cell":
        kw.pop("cell")
    elif call.startswith("engine"):
        kw["engine"] = call.split()[1]
    else:
        kw["stencil"] = tst.build_stencil_grid(
            torch.as_tensor(pos), torch.as_tensor(cell), [True] * 3,
            (12, 12, 12), (4, 4, 4))
    gt = port_grid(g)
    out = td3.grid_dftd3(gt, numbers, rcov, r4r2, c6, cna, 3.4, A1, A2, S8,
                         **kw)
    assert out[3].shape == (3, 3)
    for a, r in zip(out, grid):
        assert_close(a, r, rtol=RTOL)
    if "cell" in kw:
        window = td3.grid_dftd3(gt, numbers, rcov, r4r2, c6, cna, 3.4, A1,
                                A2, S8, compute_virial=True, cell=cell)
        assert all(torch.equal(a, w) for a, w in zip(out, window))
