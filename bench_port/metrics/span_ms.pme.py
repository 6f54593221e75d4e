# SPDX-License-Identifier: Apache-2.0
"""Device time a call in the port's ``pme`` spans: each span's pair of
CUDA events on the current stream, summed over the traced window's calls
and divided by them."""

from bench_port import spans


def read(ctx):
    return spans.device_ms(ctx, "pme")
