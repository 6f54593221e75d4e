# SPDX-License-Identifier: Apache-2.0
"""Share of the pair sweeps' device time (kernel 1, csrc/window_sweep.cu,
and kernel 4, csrc/dense_pairs.cu) that their least time takes, over
every pass of the traced calls."""

LAUNCHES = ("window_sweep_", "dense_pairs_")
DEVICE_NAMES = ("sweep_kernel", "dense_pairs_kernel")


def read(ctx):
    return ctx.roofline(LAUNCHES, DEVICE_NAMES)
