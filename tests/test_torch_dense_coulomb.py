# SPDX-License-Identifier: Apache-2.0
"""The port's dense Coulomb and matrix-product DFT against the JAX
package's, on the CPU: ``dense_coulomb_energy_forces`` and its batched
form (shared and per-system cells, bare and damped, in passes of any
size), against the port's list Coulomb; ``matmul_rfft_convolve`` against
JAX and ``torch.fft``; PME with ``fft_mode="matmul"``.

f64 outputs are held at 1e-10 of their scale; one f32 case at 1.25x the
JAX package's own f32-vs-f64 error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch.interactions.electrostatics import dense as tdense
from nvalchemiops_torch.interactions.electrostatics import pme as tpme
from nvalchemiops_torch.interactions.electrostatics.coulomb import (
    coulomb_energy_forces,
)
from nvalchemiops_torch.mathops import matmul_dft as tdft
from nvalchemiops_torch.neighborlist import neighbor_list
from nvalchemiops_tpu.interactions.electrostatics import dense as jdense
from nvalchemiops_tpu.interactions.electrostatics import pme as jpme
from nvalchemiops_tpu.mathops import matmul_dft as jdft

from tests._torch_port import assert_close

F64 = torch.float64
RTOL = 1e-10
CUTOFF = 4.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, ref):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    r = np.asarray(ref, np.float64)
    return np.abs(a - r).max() / np.abs(r).max()


def _systems(b=3, n=48, seed=60):
    """``b`` neutral systems of ``n`` atoms; their cells (a shared
    triclinic one, and one each) hold the cutoff within half a width."""
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * 10.0
    cell[0, 1], cell[2, 0] = 0.6, -0.4
    cells = np.stack([cell * (1.0 + 0.05 * i) for i in range(b)])
    frac = rng.uniform(0, 1, (b, n, 3))
    q = rng.normal(size=(b, n))
    q -= q.mean(1, keepdims=True)
    return frac, q, cell, cells


# ---------------------------------------------------------------------------
# Dense Coulomb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.35])
@pytest.mark.parametrize("cells", ["shared", "per-system"])
def test_batch_dense_coulomb_matches_jax(cells, alpha, monkeypatch):
    frac, q, cell, per = _systems()
    c = cell if cells == "shared" else per
    pos = frac @ cell if cells == "shared" else np.einsum("bnk,bkj->bnj",
                                                          frac, per)
    want = jdense.batch_dense_coulomb_energy_forces(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(c), CUTOFF, alpha)
    whole = tdense.batch_dense_coulomb_energy_forces(
        torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(c), CUTOFF,
        alpha)
    for got, w in zip(whole, want):
        assert_close(got, w, rtol=RTOL)
    # systems a pass (two of three) and rows a pass (seven of 48): the
    # same sums as one pass
    for chunk in (2 * 48 * 48, 7 * 48):
        monkeypatch.setattr(tdense, "DENSE_PAIR_CHUNK", chunk)
        parts = tdense.batch_dense_coulomb_energy_forces(
            torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(c),
            CUTOFF, alpha)
        for a, b in zip(parts, whole):
            assert torch.equal(a, b)


@pytest.mark.parametrize("alpha", [0.0, 0.35])
def test_dense_coulomb_matches_jax_and_the_list_coulomb(alpha):
    frac, q, cell, _ = _systems(b=1, n=64, seed=61)
    pos = frac[0] @ cell
    want = jdense.dense_coulomb_energy_forces(
        jnp.asarray(pos), jnp.asarray(q[0]), jnp.asarray(cell), CUTOFF, alpha)
    pos_t, q_t = torch.as_tensor(pos), torch.as_tensor(q[0])
    got = tdense.dense_coulomb_energy_forces(pos_t, q_t, torch.as_tensor(cell),
                                             CUTOFF, alpha)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=RTOL)
    nm, _, shifts = neighbor_list(pos_t, CUTOFF, cell=torch.as_tensor(cell),
                                  pbc=torch.tensor([True] * 3),
                                  max_neighbors=64, device="cpu")
    listed = coulomb_energy_forces(pos_t, q_t, torch.as_tensor(cell), CUTOFF,
                                   alpha, neighbor_matrix=nm,
                                   neighbor_matrix_shifts=shifts)
    # the dense form takes the erfc polynomial (absolute error 1.5e-7), as
    # the JAX package's does; the list form the exact erfc
    tol = RTOL if alpha == 0.0 else 2e-6
    for g, r in zip(got, listed):
        assert_close(g, r, rtol=tol)


def test_dense_coulomb_f32_within_jax_bar():
    frac, q, _, cells = _systems(seed=62)
    pos = np.einsum("bnk,bkj->bnj", frac, cells)

    def call(pkg, dtype):
        if pkg == "jax":
            return jdense.batch_dense_coulomb_energy_forces(
                *(jnp.asarray(a, dtype) for a in (pos, q, cells)), CUTOFF,
                0.35)
        tdt = {np.float64: F64, np.float32: torch.float32}[dtype]
        return tdense.batch_dense_coulomb_energy_forces(
            *(torch.as_tensor(a, dtype=tdt) for a in (pos, q, cells)),
            CUTOFF, 0.35)

    ref, j32, t32 = call("jax", np.float64), call("jax", np.float32), \
        call("torch", np.float32)
    for r, j, t in zip(ref, j32, t32):
        assert t.dtype == torch.float32
        bar = 1.25 * _err(j, r)
        assert 0.0 < _err(t, r) <= bar, (_err(t, r), bar)


# ---------------------------------------------------------------------------
# Matrix-product DFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 6, 10), (3, 8, 8, 8), (2, 5, 7, 9)])
def test_matmul_rfft_convolve_matches_jax_and_torch_fft(shape):
    rng = np.random.default_rng(63)
    mesh = rng.normal(size=shape)
    kern = rng.normal(size=shape[-3:-1] + (shape[-1] // 2 + 1,))
    got = tdft.matmul_rfft_convolve(torch.as_tensor(mesh),
                                    torch.as_tensor(kern))
    assert got.shape == shape and got.dtype == F64
    assert_close(got, jdft.matmul_rfft_convolve(jnp.asarray(mesh),
                                                jnp.asarray(kern)), rtol=RTOL)
    axes = (-3, -2, -1)
    fft = torch.fft.irfftn(torch.fft.rfftn(torch.as_tensor(mesh), dim=axes)
                           * torch.as_tensor(kern), s=shape[-3:], dim=axes,
                           norm="forward")
    assert_close(got, fft, rtol=RTOL)
    with pytest.raises(ValueError, match="rfft spectrum"):
        tdft.matmul_rfft_convolve(torch.as_tensor(mesh),
                                  torch.as_tensor(kern[..., :-1]))


def _pme_system(seed=64, b=2, n=40, box=8.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (b, n, 3))
    q = rng.normal(size=(b, n))
    q -= q.mean(-1, keepdims=True)
    return pos, q, np.eye(3) * box


@pytest.mark.parametrize("engine", ["dense", "windowed"])
def test_batch_pme_matmul_matches_jax(engine):
    pos, q, cell = _pme_system()
    args = (0.35, (16, 16, 16), 4, True, None, "matmul")
    want = jpme.batch_pme_reciprocal(jnp.asarray(pos), jnp.asarray(q),
                                     jnp.asarray(cell), *args, engine=engine)
    got = tpme.batch_pme_reciprocal(torch.as_tensor(pos), torch.as_tensor(q),
                                    torch.as_tensor(cell), *args,
                                    engine=engine)
    xla = tpme.batch_pme_reciprocal(torch.as_tensor(pos), torch.as_tensor(q),
                                    torch.as_tensor(cell), *args[:-1], "xla",
                                    engine=engine)
    for g, w, x in zip(got, want, xla):
        assert_close(g, w, rtol=RTOL)
        assert_close(g, x, rtol=RTOL)


@pytest.mark.parametrize("kind", ["windowed", "rejected mesh", "batch_idx"])
def test_pme_reciprocal_matmul_matches_jax(kind):
    pos, q, cell = _pme_system(seed=65)
    mesh = (15, 16, 16) if kind == "rejected mesh" else (16, 16, 16)
    if kind == "batch_idx":
        pos, q = pos.reshape(-1, 3), q.reshape(-1)
        cell = np.stack([cell, cell * 1.1])
        bidx = np.repeat(np.arange(2), 40).astype(np.int32)
    else:
        pos, q, bidx = pos[0], q[0], None
    kw = dict(compute_forces=True, fft_mode="matmul")
    want = jpme.pme_reciprocal_space(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cell), 0.35, mesh,
        batch_idx=None if bidx is None else jnp.asarray(bidx), **kw)
    got = tpme.pme_reciprocal_space(
        torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(cell), 0.35,
        mesh, batch_idx=None if bidx is None else torch.as_tensor(bidx), **kw)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=RTOL)
