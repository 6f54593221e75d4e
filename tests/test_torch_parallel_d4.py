# SPDX-License-Identifier: Apache-2.0
"""The port's multi-rank paths on the CPU over gloo at D = 4 (slabs of 2
cells), against the JAX package's on ``jax.devices()[:4]`` and the port's
single-process calls: the cases and bars of
``tests/test_torch_parallel.py``.

The JAX domain programs compile per function, PBC case and D (3-5 s
each, ~30 s a case under Tier-1's load), so here the grid sweeps meet
their JAX namesakes in the two cases where D shapes the ring, fully
periodic (the wrapped edges' lattice shifts) and open z (the parked
edges); the open-x and all-open cases, whose ring edges behave as in those
two and which add only local y/x pads, meet the single-process calls here
(and JAX at D = 2 in ``tests/test_torch_parallel.py``)."""

import pytest
import torch

from tests import _torch_parallel_ranks as R
from tests import _torch_parallel_refs as refs

WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return refs.spawn_world(WORLD, tmp_path_factory)


@pytest.mark.parametrize("case", R.GRID_CASES, ids=lambda c: str(c[1]))
def test_domain_sweeps_match_jax_and_single_process(outputs, case):
    refs.check_grid_case(outputs, WORLD, case,
                         with_jax=case[0] in ("pbc0", "pbc1"))


@pytest.mark.parametrize("case", R.PME_CASES, ids=lambda c: c[0])
def test_domain_pme_matches_jax_and_single_process(outputs, case):
    refs.check_pme_case(outputs, WORLD, case, refs.jax_pme)


@pytest.mark.parametrize("case", R.BATCH_CASES, ids=lambda c: c[0])
def test_sharded_batch_pme_matches_jax_and_single_process(outputs, case):
    """At D = 4 ``make_mesh``'s dp axis has two ranks."""
    refs.check_pme_case(outputs, WORLD, case, refs.jax_batch)


@pytest.mark.parametrize("mesh", R.MLIP_MESHES[WORLD],
                         ids=lambda m: f"dp{m[0]}xsp{m[1]}")
def test_sharded_train_step_matches_single_process_and_jax(outputs, mesh):
    """``sharded_train_step`` on a ``(dp, sp)`` mesh of the world: every
    rank's new parameters and global loss within 1e-12 of the
    single-process ``train_step`` on the whole batch and within 1e-9 of
    the JAX ``train_step`` (f64, each field's scale)."""
    refs.check_mlip_mesh(outputs, WORLD, *mesh)


def test_shard_batch_rejects_indivisible_shapes(outputs):
    """Every rank got ``ValueError`` from ``shard_batch`` for a batch of D
    + 1 systems on a ``(D, 1)`` mesh and one of 17 atoms on ``(1, D)``."""
    assert int(outputs["mlip_bad_shapes"]) == 2


def test_rejections_ran(outputs):
    assert int(outputs["bad_cz"]) == 3
