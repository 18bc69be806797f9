"""k1_roofline_pct: the fused hop-merge's (K1) least time per launch, from
its shapes (B, E, A, promote width) by the yardstick's bound, over its mean
device time per launch in the traced slice. The bound is HBM bytes at these
shapes (each input read once, each output written once)."""

from benchmark.harness import peaks

KERNEL = "hop_merge"


def read(run):
    t, shape = run.trace, run.info.get("hop_merge_shape")
    if t is None or shape is None:
        return None
    launches, seconds = t.op_time(KERNEL)
    if launches == 0:
        return None
    bound_s, _ = peaks.hop_merge_bound_s(*shape)
    return 100.0 * bound_s / (seconds / launches)
