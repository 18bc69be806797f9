"""The harness's spans, and the device trace of a steady slice of the window.

Spans are opened by the benchmark's own files around the calls into each
layer (spans inside the program are a later change). In a traced run each
span is also a `torch.profiler.record_function` range, so the trace shows
what the host was doing while the device idled; a span asked to `sync`
waits for the device at both ends while its total is kept (a traced run's
window outside the profiled slice), so its time is the layer's whole time;
inside the slice it does not, so the trace shows the program's own idle time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

from benchmark.harness import stats

SLICE = "traced_slice"
NAME_CHARS = 160  # a device operation's name in the breakdown (C++ kernel names run long)


class Spans:
    def __init__(self, traced: bool, device: torch.device):
        self.traced = traced
        self.device = device
        self.active = False  # totals are kept inside the window only
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.names: set[str] = set()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        self.names.add(name)
        rf = torch.profiler.record_function(name) if self.traced else None
        if rf is not None:
            rf.__enter__()
        sync = sync and self.traced and self.active
        if sync:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                self._sync()
            if self.active:
                self.totals[name] += time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the traced slice, by the trace's own clock
    busy_s: float  # the union of the device's operations inside it
    ops: dict  # device operation name -> (launches, seconds) inside the slice
    idle: dict  # what the host was doing (its open spans) -> idle seconds

    def op_time(self, substring: str) -> tuple[int, float]:
        hits = [v for k, v in self.ops.items() if substring in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:NAME_CHARS], s] for k, (_, s) in ops],
                "idle_gaps": [[k, s] for k, s in idle]}


class Capture:
    """torch.profiler over the calls between `start` and `stop`."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)
        self.rf = None

    def start(self) -> None:
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(SLICE)
        self.rf.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, span_names) -> TraceSummary:
        from torch.autograd import DeviceType

        events = self.prof.events()
        lo = hi = None
        device, notes = [], []
        for ev in events:
            tr = ev.time_range
            if ev.device_type == DeviceType.CPU:
                if ev.name == SLICE:
                    lo, hi = tr.start, tr.end
                elif ev.name in span_names:
                    notes.append((tr.start, tr.end, ev.name))
            elif (ev.device_type == DeviceType.CUDA and ev.name != SLICE
                  and ev.name not in span_names and not getattr(ev, "is_user_annotation", False)):
                # the spans' own ranges on the device's timeline are not operations
                device.append((tr.start, tr.end, ev.name))
        return summarize(device, notes, lo, hi)


def summarize(device, notes, lo: float, hi: float) -> TraceSummary:
    """Reduce device operations and host spans, (start, end, name) in
    microseconds on one clock, to the slice [lo, hi]: the union of the
    device's busy time, time by operation, and the idle time labelled by
    the host spans open when each idle gap began (outermost first)."""
    clipped = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    ops: dict = {}
    for s, e, n in clipped:
        c, t = ops.get(n, (0, 0.0))
        ops[n] = (c + 1, t + (e - s) * 1e-6)
    intervals = [(s, e) for s, e, _ in clipped]
    idle: dict = collections.defaultdict(float)
    bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(notes)]
                    + [(e, 0, i) for i, (_, e, _) in enumerate(notes)])
    open_spans: list = []
    j = 0
    for g0, g1 in stats.gaps(intervals, lo, hi):
        while j < len(bounds) and bounds[j][0] <= g0:
            _, opening, i = bounds[j]
            if opening:
                open_spans.append(i)
            elif i in open_spans:
                open_spans.remove(i)
            j += 1
        label = "/".join(notes[i][2] for i in sorted(open_spans, key=lambda i: notes[i][0]))
        idle[label or "harness"] += (g1 - g0) * 1e-6
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=stats.union_seconds(intervals) * 1e-6,
                        ops=ops, idle=dict(idle))
