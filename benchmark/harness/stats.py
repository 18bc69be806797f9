"""The benchmark's arithmetic, apart from the device so the tests reach it."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CallRecord:
    """One closed-loop call: host-clock start and end (seconds, the end after
    the results reached the host), the queries it answered, and what the
    driver counted inside it."""

    t0: float
    t1: float
    queries: int
    counts: dict = dataclasses.field(default_factory=dict)
    profiled: bool = False  # inside the traced slice, slowed by the profiler


def window_seconds(calls: list[CallRecord]) -> float:
    """From the first call's start to the last call's end."""
    return calls[-1].t1 - calls[0].t0


def steady(calls: list[CallRecord]) -> tuple[list[CallRecord], float]:
    """The calls outside the profiled slice, and their summed time."""
    out = [c for c in calls if not c.profiled]
    return out, sum(c.t1 - c.t0 for c in out)


def qps(calls: list[CallRecord]) -> float:
    """Every query answered in the window over all of the window's time."""
    return sum(c.queries for c in calls) / window_seconds(calls)


def p95_ms(calls: list[CallRecord]) -> float:
    """95th percentile of every call's latency (linear interpolation between
    order statistics, numpy's default), in milliseconds."""
    return float(np.percentile([1e3 * (c.t1 - c.t0) for c in calls], 95))


def recall_at_k(ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Share of the reference's top-k [Q, k] that the answers [Q, k] hold,
    over all Q queries; ids < 0 match nothing."""
    k = true_ids.shape[1]
    hits = (ids[:, :, None] == true_ids[:, None, :]).any(axis=1) & (true_ids >= 0)
    return float(hits.sum()) / (k * ids.shape[0])


def weighted_mean(values, weights) -> float:
    return float(sum(v * w for v, w in zip(values, weights)) / sum(weights))


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]

