# SPDX-License-Identifier: Apache-2.0
"""Share of the PME spline kernels' device time (kernels 2 and 3,
csrc/windowed_gather.cu) that their least time takes, over the traced
calls."""

LAUNCHES = ("windowed_spread", "windowed_gather_grad")
DEVICE_NAMES = ("gather_grad_kernel", "spread_kernel")


def read(ctx):
    return ctx.roofline(LAUNCHES, DEVICE_NAMES)
