"""Tracing, metrics, and structured logging.

Port of islands_tpu/utils/tracing.py. `span(block_on=...)` waits for the
CUDA devices that hold the given tensors, where the reference blocks on jax
arrays.

Reference posture (SURVEY.md §5): `tracing`/`tracing-subscriber` with
EnvFilter-style directives, JSON output compiled in but never enabled, and a
recompute-efficiency metric behind an undeclared feature flag
(src/core/leann.rs:974-981 — dead code). This module provides all three for
real: span timers that block on device work, process-wide counters, and an
optional JSON log formatter.

Hot-path spans and counters, off by default: `region(name)` and
`count(name, n)` do nothing until `enable()`. When on, a region keeps a
`Record` (its host-clock start and end on `time.perf_counter()`, its parent
and its request id) in a bounded in-memory buffer and, while a profiler
runs, opens a `torch.profiler.record_function` of the same name, so that it
sits on the device trace's clock (outside a profiler such a range records
nothing and costs most of a region's time); a counter adds a host integer
to the innermost open region's record. Neither waits for a device.
`snapshot()` returns the records, the counter totals and how many records
were dropped.

Graph replays count too: "search.hop.graphed", a hop replayed as CUDA
graphs (core/search), and "encoder.graphed", a padded BERT encode replayed
as one CUDA graph (models/bert.encode: keyed by rows, length and
normalize, captured on a shape's second call, at most ENCODE_GRAPHS_KEPT a
model), inside its "encoder.forward" region.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch


class JsonFormatter(logging.Formatter):
    """One JSON object per line (the tracing-subscriber `json` feature the
    reference ships but never turns on)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def init_logging(level: str | None = None, json_output: bool | None = None) -> None:
    """Initialize logging from args or env (ISLANDS_LOG_LEVEL,
    ISLANDS_LOG_JSON) — the reference's EnvFilter role (main.rs:186-194)."""
    level = level or os.environ.get("ISLANDS_LOG_LEVEL", "info")
    if json_output is None:
        json_output = os.environ.get("ISLANDS_LOG_JSON", "").lower() in ("1", "true")
    handler = logging.StreamHandler()
    if json_output:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"
        ))
    root = logging.getLogger("islands_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))


class Metrics:
    """Process-wide counters/gauges with thread-safe updates."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.timings: dict[str, list] = defaultdict(lambda: [0, 0.0])  # [count, total_s]

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def record_timing(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self.timings[name]
            t[0] += 1
            t[1] += seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": {
                    k: {
                        "count": n,
                        "total_s": round(total, 6),
                        "mean_s": round(total / n, 6) if n else 0.0,
                    }
                    for k, (n, total) in self.timings.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()


#: global registry (import-and-use, like the reference's global tracing)
metrics = Metrics()

logger = logging.getLogger("islands_tpu_torch.trace")

#: records kept in memory between `reset()`s; later ones are counted as dropped
RECORD_LIMIT = 1 << 20


class Record(NamedTuple):
    """One closed region: ids are unique within the process; `parent` is the
    enclosing region's id (None at a root); a root starts a new `request`
    and its descendants share it; `counts` holds the counters added while
    it was the innermost open region."""

    id: int
    name: str
    t0: float  # time.perf_counter() at entry, seconds
    t1: float  # ... at exit
    parent: int | None
    request: int
    counts: dict | None


class _Trace:
    """The process-wide buffer of the hot-path regions and counters."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the thread's open regions
        self.ids = itertools.count()
        self.requests = itertools.count()
        self.records: list[Record] = []
        self.dropped = 0
        self.counters: dict[str, int] = defaultdict(int)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def keep(self, rec: Record) -> None:
        with self.lock:
            if len(self.records) < RECORD_LIMIT:
                self.records.append(rec)
            else:
                self.dropped += 1


_trace = _Trace()
_profiling = torch._C._autograd._profiler_enabled  # is a torch profiler running?
_OFF = contextlib.nullcontext()  # the one region handed out while tracing is off


class _Region:
    __slots__ = ("name", "id", "parent", "request", "counts", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _trace.stack()
        up = st[-1] if st else None
        self.id = next(_trace.ids)
        self.parent = None if up is None else up.id
        self.request = next(_trace.requests) if up is None else up.request
        self.counts = None
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _trace.stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _trace.keep(Record(self.id, self.name, self.t0, t1, self.parent, self.request,
                           self.counts))
        return False


def enable() -> None:
    """Turn the hot-path regions and counters on (process-wide)."""
    _trace.on = True


def disable() -> None:
    """Turn them off; regions already open still close into the buffer."""
    _trace.on = False


def enabled() -> bool:
    return _trace.on


def region(name: str):
    """A context manager around one step of a hot path. Off: one shared
    no-op, with no clock read, lock, profiler range, synchronise or device
    operation. On: see the module's docstring."""
    return _Region(name) if _trace.on else _OFF


def traced(name: str):
    """Decorator: each call of the function is a `region(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with region(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add the host integer `n` to counter `name` on the innermost open
    region's record (and to the process total). Off: nothing."""
    if not _trace.on:
        return
    st = _trace.stack()
    if st:
        top = st[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n
    with _trace.lock:
        _trace.counters[name] += n


def snapshot() -> dict:
    """The closed regions' records in closing order, the counters' process
    totals and the number of records dropped past RECORD_LIMIT."""
    with _trace.lock:
        return {"records": list(_trace.records), "counters": dict(_trace.counters),
                "dropped": _trace.dropped}


def reset() -> None:
    """Empty the buffer and the counter totals (ids keep counting)."""
    with _trace.lock:
        _trace.records = []
        _trace.counters.clear()
        _trace.dropped = 0


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in `tree` (a tensor, or lists,
    tuples and dict values of them, nested)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


@contextlib.contextmanager
def span(name: str, block_on=None, log_level: int = logging.DEBUG):
    """Timed span. Pass the tensors the span computes (a tensor or a nest of
    them) as `block_on` to include their device execution: the span then
    waits for each CUDA device that holds one (kernel launches return before
    the work is done, so a span without it times only the launches). CPU
    tensors need no wait. While tracing is on it is also a `region`, the
    wait included."""
    t0 = time.perf_counter()
    try:
        with region(name):
            try:
                yield
            finally:
                if block_on is not None:
                    for dev in _cuda_devices(block_on, set()):
                        torch.cuda.synchronize(dev)
    finally:
        dt = time.perf_counter() - t0
        metrics.record_timing(name, dt)
        logger.log(log_level, "%s took %.4fs", name, dt)


def record_recompute_efficiency(n_exact: float, num_nodes: int) -> float:
    """The metric the reference dead-codes (leann.rs:974-981): fraction of
    corpus embeddings recomputed per query."""
    frac = n_exact / max(num_nodes, 1)
    metrics.gauge("recompute_fraction", frac)
    logger.debug(
        "LEANN search: computed %.0f embeddings of %d nodes (%.1f%%)",
        n_exact, num_nodes, 100.0 * frac,
    )
    return frac
