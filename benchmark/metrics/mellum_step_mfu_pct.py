"""mellum_step_mfu_pct: the Mellum FLOPs the search needed, over the calls'
time at the card's dense bf16 peak (989 TFLOP/s); calls inside the profiled
slice are left out. Needed: the rows the gate scored exactly (recompute
fraction x corpus rows x queries) at the corpus' mean FLOPs per row (from
its length multiset, `harness/moe_work.segment_flops`: the active weights,
the top 8 experts' among them, and causal attention, each row unpadded),
plus each query chunk's FLOPs. The count comes from the gate's counter and
the driver's lengths, so it is the same whatever computes it."""

from benchmark.harness import peaks


def read(run):
    calls = [c for c in run.calls if not c.profiled
             and c.counts.get("recompute_fraction") is not None and "query_flops" in c.counts]
    if not calls or "mellum_row_flops_mean" not in run.info:
        return None
    per_row = run.info["mellum_row_flops_mean"]
    flops = sum(c.counts["recompute_fraction"] * run.info["rows"] * c.queries * per_row
                + c.counts["query_flops"] for c in calls)
    seconds = sum(c.t1 - c.t0 for c in calls)
    return 100.0 * flops / (seconds * peaks.BF16_TC_FLOPS_PER_S)
