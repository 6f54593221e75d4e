# SPDX-License-Identifier: Apache-2.0
"""The device's idle share (%) over the traced calls: 1 - busy / wall,
the busy time the union of every device event's interval."""


def read(ctx):
    if ctx.lost or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
