# SPDX-License-Identifier: Apache-2.0
"""What the per-layer metrics read of the port's own spans and counters
(``nvalchemiops_torch/trace.py``).

The counters arrive in ``ctx.launch_counts``, the delta of every key of
the port's counter dict over the last traced attempt.  The spans are the
newest ``N`` of ``trace.records()``, ``N`` the sum of the ``span_n.*``
deltas: the profiler window is taken again where it lost events, and only
the last attempt's spans are read.  Each reader returns None where the
port has no such span or counter (a port without ``trace.py``)."""

from __future__ import annotations

READ = "host_read."


def total(ctx, family: str):
    """Sum of the deltas of the counters ``<family>.*``; None where the
    port has none."""
    keys = [k for k in ctx.launch_counts if k.startswith(family + ".")]
    if not keys:
        return None
    return sum(ctx.launch_counts[k] for k in keys)


def per_call(ctx, family: str):
    """:func:`total` a traced call."""
    n = total(ctx, family)
    return None if n is None or not ctx.calls else n / ctx.calls


def span_records(ctx) -> list:
    """The last traced attempt's span records (empty where none)."""
    n = total(ctx, "span_n")
    if not n:
        return []
    try:
        from nvalchemiops_torch import trace
    except ImportError:
        return []
    return trace.records(last=n)


def device_ms(ctx, name: str):
    """Device ms a traced call in spans ``name``; None where none ran or
    they hold no device time."""
    ms = [r["dev_ms"] for r in span_records(ctx) if r["name"] == name]
    if not ms or any(m is None for m in ms) or not ctx.calls:
        return None
    return sum(ms) / ctx.calls


def dispatch_ms(ctx):
    """Host ms a traced call inside the port's outermost spans, less the
    host ms of its host reads (``host_read.*`` spans, one inside another
    counted once): the host's own work in the entry points, waits for the
    device left out."""
    recs = span_records(ctx)
    if not recs or not ctx.calls:
        return None
    top = sum(r["host_ms"] for r in recs if r["depth"] == 0)
    reads = sum(r["host_ms"] for r in recs
                if r["name"].startswith(READ)
                and not (r["parent"] or "").startswith(READ))
    return (top - reads) / ctx.calls
