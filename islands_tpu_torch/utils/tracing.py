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
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict

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
        self.timings: dict[str, list[float]] = defaultdict(list)

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def record_timing(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings[name].append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": {
                    k: {
                        "count": len(v),
                        "total_s": round(sum(v), 6),
                        "mean_s": round(sum(v) / len(v), 6) if v else 0.0,
                    }
                    for k, v in self.timings.items()
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
    tensors need no wait."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            for dev in _cuda_devices(block_on, set()):
                torch.cuda.synchronize(dev)
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
