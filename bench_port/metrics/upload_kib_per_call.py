# SPDX-License-Identifier: Apache-2.0
"""Host dispatch: KiB a call the port copied from host arrays to the card
(the ``upload_bytes.*`` counters), over the traced window's calls."""

from bench_port import spans


def read(ctx):
    n = spans.per_call(ctx, "upload_bytes")
    return None if n is None else n / 1024.0
