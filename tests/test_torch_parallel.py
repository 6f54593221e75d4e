# SPDX-License-Identifier: Apache-2.0
"""The port's multi-rank paths on the CPU over gloo at D = 2 (and a world
of one), against the JAX package's and the port's single-process calls.

The world is spawned once through ``parallel._dist.spawn_ranks``; its
ranks run every case of ``tests/_torch_parallel_ranks.py`` in f64 on CPU
tensors (the kernels as their plain versions) and rank 0 writes the
outputs.  The grid systems are ``tests/test_domain.py``'s: 800 atoms in a
32 A box, 4 A cutoff, 8 cells a side, radius 1 (slabs of 4 cells at D =
2); fully periodic and the three mixed cases.  Each of the six domain and
sharded-PME functions is held to its JAX namesake on ``jax.devices()[:2]``
within 1e-9 of each output's scale, and to the port's single-process call
within 1e-10 (``tests/_torch_parallel_refs.py``).
``tests/test_torch_parallel_d4.py`` does the same at D = 4.
"""

import pytest
import torch

from nvalchemiops_torch.parallel._dist import spawn_ranks

from tests import _torch_parallel_ranks as R
from tests import _torch_parallel_refs as refs

WORLD = 2


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
    """``domain_dftd3_cn``, ``domain_coulomb_energy_forces``,
    ``domain_dftd3`` and ``domain_dftd3_coulomb`` on two slabs."""
    refs.check_grid_case(outputs, WORLD, case)


@pytest.mark.parametrize("case", R.PME_CASES, ids=lambda c: c[0])
def test_domain_pme_matches_jax_and_single_process(outputs, case):
    """``domain_pme_reciprocal``: the tiles split over the ranks (kernels 3
    and 2 as their plain versions), with and without forces."""
    refs.check_pme_case(outputs, WORLD, case, refs.jax_pme)


@pytest.mark.parametrize("case", R.BATCH_CASES, ids=lambda c: c[0])
def test_sharded_batch_pme_matches_jax_and_single_process(outputs, case):
    """``sharded_batch_pme_reciprocal`` on the dense route over a 1-D
    ``("dp",)`` mesh and the windowed route over ``make_mesh``'s dp
    axis."""
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
    """Every rank checked the ``ValueError`` cases: a 3-cell z axis does
    not split into slabs, a batch of D + 1 does not divide, the windows
    reject a 36^3 mesh, an 8^3 mesh has one tile."""
    assert int(outputs["bad_cz"]) == 3


def test_dryrun_multichip_rank_body_ran(outputs):
    """Both ranks ran ``entry.dryrun_multichip``'s rank body on the CPU
    (the sharded training step at 2 x 32 atoms, the domain sweeps, the
    tile-split and batch-split PME, every output finite)."""
    assert int(outputs["dryrun"]) == 1


def test_world_of_one_is_the_local_ring(tmp_path_factory):
    """D = 1 (the ring a local copy with both lattice shifts): the fully
    periodic and open-z grid cases and the PME with forces equal the
    single-process calls within 1e-10."""
    names = ("pbc0", "pbc1", "pme_forces")
    got = refs.spawn_world(1, tmp_path_factory, names)
    one = {k: v for k, v in refs.single().items()
           if k.split("/")[0] in names}
    assert len(one) == 2 * len(refs.GRID_KEYS) + 2
    for name, want in one.items():
        refs.within(got[name], want, refs.SINGLE_TOL, f"{name} (D = 1)")


def test_launcher_fails_on_a_child_error():
    with pytest.raises(RuntimeError, match="rank 1 exit"):
        spawn_ranks(R.fail_on_rank, 2, "gloo", args=(1,), deadline_s=120.0)


def test_launcher_kills_ranks_past_the_deadline():
    with pytest.raises(TimeoutError, match="killed"):
        spawn_ranks(R.sleep_forever, 1, "gloo", deadline_s=2.0)
