# SPDX-License-Identifier: Apache-2.0
"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel (csrc/) for float32 tensors on a
CUDA device, on that card, and takes its plain version for every other
tensor (on the CPU, or of another dtype on the card), on the tensor's
device (``build.launches_kernel``); it never falls back from one to the
other.  ``launch_counts`` counts kernel launches per wrapper and body
(a batched grid's launch under the same key), so a run can show that the
main path went through the kernels.  It is the port's one counter dict,
``trace.counts``: the launch keys (``trace.LAUNCH_KEYS``) have no dot, and
the other counters of ``trace.py`` are ``<family>.<name>`` keys beside
them; :func:`launches` holds the launch counts alone.
"""

from nvalchemiops_torch.trace import LAUNCH_KEYS, counts as launch_counts


def reset_launch_counts() -> None:
    """Set every count of ``launch_counts`` to zero."""
    for k in launch_counts:
        launch_counts[k] = 0


def launches() -> dict:
    """The launch counts alone (no ``<family>.<name>`` counter): a copy."""
    return {k: launch_counts[k] for k in LAUNCH_KEYS}


__all__ = ["LAUNCH_KEYS", "launch_counts", "launches", "reset_launch_counts"]
