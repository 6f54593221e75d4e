# SPDX-License-Identifier: Apache-2.0
"""Interaction models of the PyTorch port."""
