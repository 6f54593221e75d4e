# SPDX-License-Identifier: Apache-2.0
"""Plain PyTorch references for the benchmark's ``correct`` check.

Written from the formulas, independent of the package under test: it
imports nothing of ``nvalchemiops_torch`` (nor JAX) and takes nothing the
package made.  Neighbours, the PME mesh and every force are worked out
again here; forces come from autograd of the energies.  Each function
computes in ``dtype`` (float64 for the reference; bfloat16 for the
control) and sums per atom in ``acc`` (float64, or float32 for the
control).
"""
