# SPDX-License-Identifier: Apache-2.0
"""Host dispatch: host ms a call inside the port's outermost spans (its
entry points), less the host ms of the host reads inside them
(``host_read.*`` spans), over the traced window's calls."""

from bench_port import spans


def read(ctx):
    return spans.dispatch_ms(ctx)
