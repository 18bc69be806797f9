"""hops_per_call: hops of the gated loop per call, counted by the fused
hop-merge's launch counter (ops.hop_merge.launches; one launch a hop)."""


def read(run):
    hops = [c.counts["hops"] for c in run.calls if "hops" in c.counts]
    return sum(hops) / len(hops) if hops else None
