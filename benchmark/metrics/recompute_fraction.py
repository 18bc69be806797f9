"""recompute_fraction: the LEANN gate's exact scores per query over the
corpus rows (LeannIndex.last_recompute_fraction), weighted by each call's
queries."""

from benchmark.harness import stats


def read(run):
    calls = [c for c in run.calls if c.counts.get("recompute_fraction") is not None]
    if not calls:
        return None
    return stats.weighted_mean([c.counts["recompute_fraction"] for c in calls],
                               [c.queries for c in calls])
