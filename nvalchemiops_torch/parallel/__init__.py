# SPDX-License-Identifier: Apache-2.0
"""Multi-rank paths on ``torch.distributed`` (counterpart of
``nvalchemiops_tpu.parallel``).

The JAX package runs SPMD programs over a ``jax.sharding.Mesh`` from one
process.  The port runs one process per rank: the caller initialises the
process group (NCCL with one rank per card, or gloo), builds a
``DeviceMesh`` with the JAX axis names (:func:`make_z_mesh`,
:func:`make_mesh`), and every rank calls a function with the same
replicated inputs and gets the whole result back.

- :mod:`~nvalchemiops_torch.parallel.domain`: the z-slab domain
  decomposition of the halo-grid sweeps (kernel 1 on each slab, halos
  over a ring of point-to-point exchanges) and the tile-split PME
  (kernels 3 and 2);
- :mod:`~nvalchemiops_torch.parallel.batch_pme`: the batch-split PME;
- :mod:`~nvalchemiops_torch.parallel.mlip`: the MLIP's forward pass, its
  training step, and the step sharded over the ``("dp", "sp")`` mesh.

Importing it builds no kernel and starts no process group.
"""

from nvalchemiops_torch.parallel.mlip import (  # noqa: F401
    D3Tables,
    MLIPParams,
    batched_energy_forces,
    default_d3_tables,
    init_mlip_params,
    make_mesh,
    mlip_energy,
    shard_batch,
    sharded_train_step,
    train_step,
)
from nvalchemiops_torch.parallel.domain import (  # noqa: F401
    domain_coulomb_energy_forces,
    domain_dftd3,
    domain_dftd3_cn,
    domain_dftd3_coulomb,
    domain_pme_reciprocal,
    make_z_mesh,
)
from nvalchemiops_torch.parallel.batch_pme import (  # noqa: F401
    sharded_batch_pme_reciprocal,
)

__all__ = [
    "MLIPParams",
    "batched_energy_forces",
    "sharded_batch_pme_reciprocal",
    "domain_coulomb_energy_forces",
    "domain_dftd3",
    "domain_dftd3_cn",
    "domain_dftd3_coulomb",
    "domain_pme_reciprocal",
    "init_mlip_params",
    "make_mesh",
    "make_z_mesh",
    "mlip_energy",
    "shard_batch",
    "sharded_train_step",
    "train_step",
]
