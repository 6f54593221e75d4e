# SPDX-License-Identifier: Apache-2.0
"""Interaction models of the PyTorch port: dispersion (DFT-D3) and
electrostatics."""

from nvalchemiops_torch.interactions import dispersion, electrostatics

__all__ = ["dispersion", "electrostatics"]
