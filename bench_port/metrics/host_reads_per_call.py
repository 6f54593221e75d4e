# SPDX-License-Identifier: Apache-2.0
"""Host dispatch: the times a call the host waited for the device inside
the port (the ``host_reads.*`` counters: device-to-host reads, and copies
of host arrays that end in a stream synchronisation), over the traced
window's calls."""

from bench_port import spans


def read(ctx):
    return spans.per_call(ctx, "host_reads")
