# SPDX-License-Identifier: Apache-2.0
"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its CUDA kernel (csrc/) for tensors on a CUDA device; it never falls back
from one to the other.  ``launch_counts`` counts kernel launches per
wrapper, so a run can show that the main path went through the kernels.
"""

launch_counts = {
    "window_sweep_cn": 0,
    "window_sweep_d3_direct": 0,
    "window_sweep_chain": 0,
    "window_sweep_coulomb": 0,
    "window_sweep_d3_direct_coulomb": 0,
    "window_sweep_batch_cn": 0,
    "window_sweep_batch_d3_direct": 0,
    "window_sweep_batch_chain": 0,
    "window_sweep_batch_coulomb": 0,
    "window_sweep_batch_d3_direct_coulomb": 0,
    "windowed_spread": 0,
    "windowed_gather_grad": 0,
    "dense_pairs_cn": 0,
    "dense_pairs_direct": 0,
    "dense_pairs_chain": 0,
    "separable_spread": 0,
    "separable_gather": 0,
    "row_sweep_cn": 0,
    "row_sweep_d3_direct": 0,
    "row_sweep_chain": 0,
    "chunk_sweep_cn": 0,
    "chunk_sweep_d3_direct": 0,
    "chunk_sweep_d3_direct_coulomb": 0,
    "chunk_sweep_chain": 0,
    "chunk_sweep_coulomb": 0,
    "stencil_sweep_cn": 0,
    "stencil_sweep_chain": 0,
    "stencil_sweep_coulomb": 0,
}


def reset_launch_counts() -> None:
    """Set every launch count to zero."""
    for k in launch_counts:
        launch_counts[k] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
