# SPDX-License-Identifier: Apache-2.0
"""The port's counters and spans, for whoever profiles the library.

**Counters** (:data:`counts`, one dict for the process) always count, at
the cost of a dict increment and no device work.  The kernel wrappers
count their launches under keys without a dot (``window_sweep_cn``,
``dense_pairs_direct``, ...; :data:`LAUNCH_KEYS`), re-exported as
``kernels.launch_counts``.  Every other key is ``<family>.<name>``:

- ``host_reads.<site>``: times the host waited for the device at
  ``<site>``.  A device-to-host read (``int(t)``, ``t.cpu()``, and the ops
  that read a result back to size or check theirs: ``torch.linalg.inv``
  reads its error flag, ``torch.bincount`` its input's least and largest
  values, two reads), and a copy from host memory that PyTorch completes
  with a stream synchronisation (every :func:`upload`).  Counted only
  where the device is a CUDA device;
- ``uploads.<site>`` / ``upload_bytes.<site>``: host arrays, lists and
  numbers copied to a CUDA device at ``<site>``, and their bytes on the
  device (:func:`upload`);
- ``slot_pairs.<kernel>_<body>``: the slot pairs a grid sweep's launches
  test for distance (kernel 1: ``window_sweep``; kernels 7 and 8:
  ``row_sweep``, ``chunk_sweep``): host arithmetic on the shapes;
- ``resident_warps.window_sweep_<body>``: each kernel 1 launch's slot
  pairs times the warps an SM holds of its instantiation at its shared
  memory (the card's occupancy calculator); over ``slot_pairs`` of the
  same body, the resident warps weighted by the tests made at them;
- ``span_n.<name>``: spans of ``<name>`` recorded (counted only while a
  profiler records).

**Spans** (:func:`span`) time the library's layers while a
``torch.profiler`` session records, and cost one flag read otherwise: no
environment variable and no argument switches them; the program is traced
exactly when it is profiled.  Each public entry point opens one:

- ``grid_build``: ``grid.batch_build_atom_grid`` (and so
  ``build_atom_grid``);
- ``d3``: the D3 entry point the caller used (``grid_dftd3``,
  ``batch_dftd3``, ``batch_grid_dftd3``, ``batch_dense_dftd3``), once a
  call, with children ``d3.route`` (the batch router), ``d3.inputs``
  (tables, element numbers and their slot planes), ``d3.cn``,
  ``d3.features``, ``d3.direct``, ``d3.chain`` (the three passes and the
  interpolation features between them) and ``d3.gather`` (slots back to
  atoms), on the grid and the dense engines alike; the batched grid's
  ``grid_build`` runs inside it;
- ``coulomb``: ``grid.grid_coulomb_energy_forces``;
- ``pme``: ``pme.pme_reciprocal_space``, with children ``pme.tiles``,
  ``pme.spread``, ``pme.fft`` and ``pme.gather``;
- ``host_read.<site>``: around each counted host read, host times only
  (the wait is the host's; its device events would cost more than the
  read).

A span whose name is already open opens no second one (``batch_dftd3``
calling ``batch_grid_dftd3`` makes one ``d3``).  A recorded span holds its
name, its parent, its depth and its host start and end in
``time.time_ns()``, the clock ``torch.profiler`` stamps its host events
with, so a span lines up with the profiler's trace; where CUDA is
initialised, also a timing ``torch.cuda.Event`` pair on the current
stream.  :func:`records` returns them.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

__all__ = ["LAUNCH_KEYS", "FAMILIES", "counts", "count", "span", "spanned",
           "host_read", "upload", "records", "clear_records", "MAX_RECORDS"]

#: the kernel wrappers' launch counts, one key per wrapper and body
LAUNCH_KEYS = (
    "window_sweep_cn",
    "window_sweep_d3_direct",
    "window_sweep_chain",
    "window_sweep_coulomb",
    "window_sweep_d3_direct_coulomb",
    "windowed_spread",
    "windowed_gather_grad",
    "dense_pairs_cn",
    "dense_pairs_direct",
    "dense_pairs_chain",
    "separable_spread",
    "separable_gather",
    "row_sweep_cn",
    "row_sweep_d3_direct",
    "row_sweep_chain",
    "chunk_sweep_cn",
    "chunk_sweep_d3_direct",
    "chunk_sweep_d3_direct_coulomb",
    "chunk_sweep_chain",
    "chunk_sweep_coulomb",
    "stencil_sweep_cn",
    "stencil_sweep_chain",
    "stencil_sweep_coulomb",
)

#: the counter families beside the launch counts (keys ``<family>.<name>``)
FAMILIES = ("host_reads", "uploads", "upload_bytes", "slot_pairs",
            "resident_warps", "span_n")

#: the process's counters: launch counts, then ``<family>.<name>`` keys as
#: they first count
counts = dict.fromkeys(LAUNCH_KEYS, 0)

#: spans kept (the oldest dropped first)
MAX_RECORDS = 65536

_records = deque(maxlen=MAX_RECORDS)
_open = threading.local()


#: the span of an untraced program: records nothing
_OFF = contextlib.nullcontext()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key``."""
    counts[key] = counts.get(key, 0) + n


class _Span:
    """One recorded span: host times, and device events where CUDA is
    initialised."""

    __slots__ = ("name", "parent", "depth", "events", "t0_ns", "t1_ns",
                 "ev0", "ev1", "dev_ms")

    def __init__(self, name: str, parent, depth: int, events: bool):
        self.name, self.parent, self.depth = name, parent, depth
        self.events = events
        self.ev0 = self.ev1 = self.dev_ms = None

    def __enter__(self):
        _open.stack.append(self.name)
        if self.events and torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        _open.stack.pop()
        _records.append(self)
        count("span_n." + self.name)
        return False


def span(name: str, events: bool = True):
    """A context manager that records span ``name`` while a
    ``torch.profiler`` session records; otherwise one shared no-op (one
    flag read).  A span of a name already open records nothing.
    ``events=False`` records host times only (a traced span's two CUDA
    events cost the most of it)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    if name in stack:
        return _OFF
    return _Span(name, stack[-1] if stack else None, len(stack), events)


def spanned(name: str):
    """Decorator: the function's every call inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _on_cuda(device) -> bool:
    if not isinstance(device, torch.device):
        device = torch.device(device)
    return device.type == "cuda"


def host_read(site: str, device, n: int = 1):
    """Count ``n`` host reads at ``site`` where ``device`` is a CUDA
    device, and return the span ``host_read.<site>`` to wrap them in."""
    if not _on_cuda(device):
        return _OFF
    count("host_reads." + site, n)
    return span("host_read." + site, events=False)


def upload(a, device, dtype, site: str):
    """``torch.as_tensor(a, dtype=dtype, device=device)`` (``dtype`` None
    keeps ``a``'s), counted: where ``a`` is a host array, list, number or
    CPU tensor and ``device`` a CUDA device, one ``uploads.<site>``, its
    bytes on the device under ``upload_bytes.<site>``, and the stream
    synchronisation that completes a copy from pageable host memory as a
    host read (``host_reads.<site>``, span ``host_read.<site>``).  The
    dtype is converted on the host, as ``Tensor.to`` converts it for such
    a copy."""
    if not _on_cuda(device) or (isinstance(a, torch.Tensor)
                                and a.device.type != "cpu"):
        return torch.as_tensor(a, dtype=dtype, device=device)
    host = torch.as_tensor(a, dtype=dtype)
    count("uploads." + site)
    count("upload_bytes." + site, host.numel() * host.element_size())
    with host_read(site, device):
        return host.to(device)


def records(last: int | None = None) -> list[dict]:
    """The recorded spans, oldest first (the ``last`` newest where given):
    dicts ``name, parent, depth, t0_ns, t1_ns, host_ms, dev_ms``.
    ``dev_ms`` is the device time between the span's two events (None
    without them); the device is synchronised once to read them."""
    kept = list(_records)
    if last is not None:
        kept = kept[len(kept) - last:] if last > 0 else []
    if any(r.ev0 is not None and r.dev_ms is None for r in kept):
        torch.cuda.synchronize()
        for r in kept:
            if r.ev0 is not None and r.dev_ms is None:
                r.dev_ms = r.ev0.elapsed_time(r.ev1)
                r.ev0 = r.ev1 = None
    return [{"name": r.name, "parent": r.parent, "depth": r.depth,
             "t0_ns": r.t0_ns, "t1_ns": r.t1_ns,
             "host_ms": (r.t1_ns - r.t0_ns) * 1e-6, "dev_ms": r.dev_ms}
            for r in kept]


def clear_records() -> None:
    """Drop every recorded span."""
    _records.clear()
