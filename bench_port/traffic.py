# SPDX-License-Identifier: Apache-2.0
"""What every traffic generator shares: the run's seed split into
streams, and the inputs of a run (:class:`Traffic`).

A traffic mix is a file ``workloads/<traffic>.json`` of parameters; the
generator that reads it is the configuration's system module
(``systems/<system>.py``, its ``make_traffic(config, mix, seed,
device)``), which knows the configuration's layout.  Every seed gives the
same sizes; only the draws differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def seed_value(seed: int) -> int:
    """The seed as a non-negative 63-bit integer (any whole number is a
    valid ``--seed``)."""
    return int(seed) % (1 << 63)


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for stream ``stream`` of the run's seed."""
    return np.random.default_rng([seed_value(seed), stream])


def device_rng(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_value(seed) ^ (stream * 0x9E3779B97F4A7C15 % (1 << 63)))
    return g


@dataclass
class Traffic:
    """The inputs of every call: ``positions[k]`` (float32, on the device)
    is set ``k``; ``numbers[k]`` (int32, numpy) its element numbers;
    ``cell`` (numpy ``[3, 3]``) is shared; ``charges`` (float32, on the
    device) where the configuration has charges; ``systems`` and
    ``atoms`` per system."""

    positions: list
    numbers: list
    cell: np.ndarray
    charges: torch.Tensor | None
    systems: int
    atoms: int

    @property
    def atoms_per_call(self) -> int:
        return self.systems * self.atoms
