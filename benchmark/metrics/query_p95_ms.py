"""query_p95_ms: the 95th percentile of every call's latency in the window,
from its start to its answers on the host (host clock)."""

from benchmark.harness import stats


def read(run):
    return stats.p95_ms(run.calls)
