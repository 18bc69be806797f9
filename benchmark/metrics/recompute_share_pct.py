"""recompute_share_pct: the share of the calls' time spent inside the
recompute provider's `embed`, in the benchmark's span "embed", which waits
for the device at both ends in the traced run outside the profiled slice.
Calls inside that slice are left out on both sides."""

from benchmark.harness import stats


def read(run):
    calls, seconds = stats.steady(run.calls)
    if "embed" not in run.spans or not calls:
        return None
    return 100.0 * run.spans["embed"] / seconds
