# SPDX-License-Identifier: Apache-2.0
"""Host dispatch: the kernel launches, memsets and copies the host's
runtime recorded a call in the traced window, plain torch ops included."""


def read(ctx):
    return ctx.host_launches / ctx.calls if ctx.calls else None
