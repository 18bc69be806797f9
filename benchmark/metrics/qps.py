"""qps: every query answered in the window over all of the window's time
(host clock; the window ends after the last call's answers reached the host)."""

from benchmark.harness import stats


def read(run):
    return stats.qps(run.calls)
