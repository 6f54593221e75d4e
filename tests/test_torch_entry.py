# SPDX-License-Identifier: Apache-2.0
"""The port's entry points (``nvalchemiops_torch.entry``) on the CPU.

``entry(device="cpu")`` returns the MLIP forward and its inputs at the JAX
``entry()``'s shapes (4 x 256 atoms, zmax 4, 6 A boxes, 2.9 A): the
inputs equal JAX's bit for bit, and the f32 forward agrees with JAX's f32
forward within 1e-6 of each output's scale, its error against JAX's f64
forward at most 1.25x JAX's own f32 error.  ``dryrun_multichip`` runs one
rank here over gloo (the two-rank world runs its rank body in
``tests/test_torch_parallel.py``) and refuses what it cannot run: a card
that is not there, NCCL on the CPU, more NCCL ranks than cards.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from nvalchemiops_torch import entry
from nvalchemiops_tpu.parallel import mlip as jmlip

F32_TOL = 1e-6
F32_FACTOR = 1.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX ``entry()``'s f32 forward, and the same forward in f64."""
    forward, args = jentry.entry()
    e32, f32 = jax.jit(forward)(*args)
    params = jmlip.init_mlip_params(4, jnp.float64)
    tables = jmlip.default_d3_tables(4, dtype=jnp.float64)
    pos, numbers, cell, _, _ = jentry._make_batch(4, 256, 4, jnp.float64)
    e64, f64 = jax.jit(jmlip.batched_energy_forces, static_argnums=5)(
        params, tables, pos, numbers, cell, 2.9)
    return args, (np.asarray(e32), np.asarray(f32)), (np.asarray(e64),
                                                      np.asarray(f64))


def test_entry_forward_matches_jax_f32():
    forward, args = entry.entry(device="cpu")
    jargs, want32, want64 = _jax_forward()
    params, positions, numbers, cell = args
    assert positions.device.type == "cpu" and positions.dtype == torch.float32
    for got, ref in zip((positions, numbers, cell), jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for f in params._fields:
        np.testing.assert_allclose(getattr(params, f).numpy(),
                                   np.asarray(getattr(jargs[0], f)),
                                   rtol=2 * np.finfo(np.float32).eps, atol=0)
    energies, forces = forward(*args)
    assert energies.shape == (4,) and forces.shape == (4, 256, 3)
    for got, w32, w64, what in zip((energies, forces), want32, want64,
                                   ("energies", "forces")):
        assert _scale_err(got, w32) <= F32_TOL, what
        assert _scale_err(got, w64) <= F32_FACTOR * _scale_err(w32, w64), what


def test_make_batch_is_the_jax_batch():
    """All five arrays, targets included, in f64."""
    got = entry.make_batch(2, 8, dtype=torch.float64, device="cpu")
    want = jentry._make_batch(2, 8, 4, jnp.float64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dryrun_multichip_one_rank_on_the_cpu():
    assert entry.dryrun_multichip(1, device="cpu") is None


def test_entry_points_need_the_card_by_default(monkeypatch):
    """With no card the defaults raise: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)


def test_more_nccl_ranks_than_cards_names_gloo(monkeypatch):
    """On one card, two NCCL ranks are refused before any process starts,
    naming ``backend="gloo"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="gloo"):
        entry.dryrun_multichip(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        entry.dryrun_multichip(2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="n_devices"):
        entry.dryrun_multichip(0, device="cpu")
