# SPDX-License-Identifier: Apache-2.0
"""The traced window: a few calls right after warm-up under
``torch.profiler``, with CUDA events at the stage boundaries and the work
of every kernel launch recorded from the wrappers' arguments.

torch.profiler can drop the device events of whole calls (seen late in
long processes); a run counts as whole only where the device's kernels
number at least the kernel launches the host recorded (the host's
records are never lost; a copy or memset of no bytes makes no device
event, so those are not counted).  Kernel names that count no multiple
of the calls are printed beside it: a call's launches may depend on its
data, so they are a hint, not the test.  A run that lost events is taken
again, and the loss printed; after the last try the metrics that need
device times are left out.
"""

from __future__ import annotations

import importlib
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

from bench_port import peaks

TRIES = 3
#: host runtime records of device work: kernel launches, then memsets
#: and copies (which make no device event where they move no bytes)
HOST_WORK = ("Launch", "Memset", "Memcpy")
#: device events of memsets and copies (every other device event is a
#: kernel)
DEVICE_COPIES = ("Memcpy", "Memset")
#: the harness's own ranges (``record_function``: a call, and each stage
#: in it), which the profiler also lays on the device's timeline as
#: annotations: no device work
RANGE = "bench_port."
CALL_RANGE = RANGE + "call"
STAGE_RANGE = RANGE + "stage."


@dataclass
class TraceContext:
    """What the per-layer metric readers (``metrics/<name>.py``) read."""

    calls: int
    window_s: float
    busy_s: float
    host_launches: int       # kernel launches, memsets and copies
    lost: bool
    kernels: list            # [(name, start_us, end_us)] device events
    stage_ms: dict           # stage -> [ms per call]
    works: list              # [(kernel base, key, bytes, flops)]
    launch_counts: dict      # the program's launch counter, traced calls
    breakdown: dict = field(default_factory=dict)

    def stage_mean(self, stage: str):
        ms = self.stage_ms.get(stage)
        return sum(ms) / len(ms) if ms else None

    def roofline(self, launch_prefixes, device_names):
        """Share (%) of the device time of the kernels whose launch-count
        keys start with ``launch_prefixes`` (and whose device names contain
        one of ``device_names``) that their least time takes: the larger of
        bytes over peak bandwidth and flops over peak float32 rate, summed
        over their launches.  None where events were lost, nothing
        launched, or a launch has no work count."""
        if self.lost:
            return None
        launched = sum(c for k, c in self.launch_counts.items()
                       if k.startswith(tuple(launch_prefixes)))
        works = [w for w in self.works
                 if any(w[1].replace("[", "_").rstrip("]").startswith(p)
                        for p in launch_prefixes)]
        if not launched or len(works) != launched:
            return None
        bound_s = sum(max(b / peaks.PEAK_BYTES_PER_S,
                          f / peaks.PEAK_FP32_PER_S) for _, _, b, f in works)
        dev_s = sum(e - s for n, s, e in self.kernels
                    if any(d in n for d in device_names)) * 1e-6
        return 100.0 * bound_s / dev_s if dev_s > 0 else None


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read_profile(prof):
    """``(kernels, host_ops, host_work)``: the device events, the host ops
    (name, start, end), and the runtime's launches, memsets and copies the
    host recorded, counted by kind (``HOST_WORK``)."""
    from torch.autograd import DeviceType

    kernels, host, launched = [], [], Counter()
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(RANGE):
                kernels.append((e.name, s, t))
            continue
        host.append((e.name, s, t))
        if e.name.startswith("cu"):
            kind = next((w for w in HOST_WORK if w in e.name), None)
            if kind:
                launched[kind] += 1
    return kernels, host, launched


def events_whole(kernels, launched: int) -> bool:
    """The device's kernels (events other than copies and memsets) number
    at least the host's kernel launches ``launched`` (and there are
    some)."""
    kept = sum(1 for n, _, _ in kernels if not n.startswith(DEVICE_COPIES))
    return kept > 0 and kept >= launched


def uneven_names(kernels, calls: int) -> dict:
    """Kernel names whose count is no multiple of ``calls``."""
    kept = Counter(n for n, _, _ in kernels)
    return {n[:100]: c for n, c in kept.items() if c % calls}


def _label(gap_mid, host):
    """What the host was doing in an idle gap: the stage it was in, and
    the shortest host op that covers the gap's middle (none: Python
    between ops); outside any call, the harness between calls."""
    op, stage, in_call = None, None, False
    for name, s, e in host:
        if not s <= gap_mid <= e:
            continue
        if name == CALL_RANGE:
            in_call = True
        elif name.startswith(STAGE_RANGE):
            stage = name[len(STAGE_RANGE):]
        elif op is None or e - s < op[1]:
            op = (name, e - s)
    if not in_call:
        return "between calls"
    return f"{stage or 'call'}: {op[0] if op else 'python'}"


def breakdown(kernels, host, top: int = 10):
    """``device_ops``: the device operations that took most time, summed
    by name; ``idle_gaps``: idle device time between the first and last
    device event, summed by what the host was doing."""
    by_name = Counter()
    for n, s, e in kernels:
        by_name[n[:160]] += (e - s) * 1e-6
    gaps = Counter()
    ivs = sorted((s, e) for _, s, e in kernels)
    end = None
    for s, e in ivs:
        if end is not None and s > end:
            gaps[_label(0.5 * (s + end), host)[:160]] += (
                s - end) * 1e-6
        end = e if end is None else max(end, e)
    return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


class WorkRecorder:
    """Wraps each kernel wrapper that a ``roofline/<kernel>.py`` module
    names (its ``WRAPS``) and records the work of every launch while on."""

    def __init__(self, roofline_modules, ctx):
        self.ctx = ctx
        self.on = False
        self.works = []
        self._undo = []
        for base, mod in roofline_modules.items():
            for mod_name, attr in mod.WRAPS:
                target = importlib.import_module(mod_name)
                self._wrap(target, attr, base, mod.work)

    def _wrap(self, target, attr, base, work):
        orig = getattr(target, attr)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.on and torch.is_tensor(_first_tensor(args)) and \
                    _first_tensor(args).is_cuda:
                key = f"{base}[{args[0]}]" if isinstance(args[0], str) \
                    else base
                b, f = work(args, kwargs, out, self.ctx)
                self.works.append((base, key, b, f))
            return out

        setattr(target, attr, wrapper)
        self._undo.append((target, attr, orig))

    def restore(self):
        for target, attr, orig in reversed(self._undo):
            setattr(target, attr, orig)
        self._undo.clear()


class _Mark:
    """A stage boundary: a CUDA event on the card (the host's clock in a
    rehearsal on the CPU)."""

    def __init__(self, on_card: bool):
        if on_card:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def ms_to(self, later) -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


def _first_tensor(args):
    return next((a for a in args if torch.is_tensor(a)), None)


def traced_window(cell, calls: int, roofline_modules, counts):
    """Run ``calls`` calls of ``cell`` under the profiler (taken again where
    events were lost) and return a :class:`TraceContext`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(cell.device).type == "cuda"
    recorder = WorkRecorder(roofline_modules, cell.roofline_context())
    try:
        for attempt in range(TRIES):
            recorder.works = []
            stage_ms = {}
            before = dict(counts)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                recorder.on = True
                t0 = time.perf_counter()
                for c in range(calls):
                    marks, ranges = [], []

                    def mark(stage, marks=marks, ranges=ranges):
                        # a CUDA event, and a profiler range a stage
                        marks.append((stage, _Mark(on_card)))
                        if ranges:
                            ranges.pop().__exit__(None, None, None)
                        if stage is not None:
                            ranges.append(record_function(STAGE_RANGE + stage))
                            ranges[-1].__enter__()

                    with record_function(CALL_RANGE):
                        cell.call(c, mark)
                        if on_card:
                            torch.cuda.synchronize()
                    for (st, a), (_, b) in zip(marks, marks[1:]):
                        stage_ms.setdefault(st, []).append(a.ms_to(b))
                window_s = time.perf_counter() - t0
                recorder.on = False
            kernels, host, work = read_profile(prof)
            launched = work["Launch"]
            whole = events_whole(kernels, launched)
            uneven = uneven_names(kernels, calls)
            if uneven:
                print(f"[bench_port] kernel names that count no multiple of "
                      f"the {calls} calls: {uneven}", file=sys.stderr)
            if whole or attempt == TRIES - 1:
                break
            print(f"[bench_port] profiler lost device events (try "
                  f"{attempt + 1}): {len(kernels)} device events, {launched}"
                  f" kernel launches, {calls} calls; taken again",
                  file=sys.stderr)
        if not whole:
            print("[bench_port] profiler lost device events on every try: "
                  "device-time metrics left out", file=sys.stderr)
        delta = {k: counts[k] - before.get(k, 0) for k in counts}
        return TraceContext(
            calls=calls, window_s=window_s,
            busy_s=_union_us([(s, e) for _, s, e in kernels]) * 1e-6,
            host_launches=sum(work.values()), lost=not whole,
            kernels=kernels,
            stage_ms=stage_ms, works=list(recorder.works),
            launch_counts=delta, breakdown=breakdown(kernels, host))
    finally:
        recorder.restore()
