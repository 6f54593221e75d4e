# SPDX-License-Identifier: Apache-2.0
"""The coulomb stage's time a call: CUDA events at its start and end, the
mean over the traced window's calls."""


def read(ctx):
    return ctx.stage_mean("coulomb")
