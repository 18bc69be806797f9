"""step_mfu_pct: the encoder FLOPs the search needed, over the calls' time
at the card's dense bf16 peak (989 TFLOP/s); calls inside the profiled
slice are left out. Needed: the rows the gate
scored exactly (recompute fraction x corpus rows x queries) at the corpus'
mean valid tokens, plus the query chunks' valid tokens, at the encoder's
FLOPs per token at the table's sequence length. The count comes from the
gate's counter and the traffic, so it is the same whatever computes it."""

from benchmark.harness import peaks, stats


def read(run):
    calls, seconds = stats.steady(run.calls)
    calls = [c for c in calls if c.counts.get("recompute_fraction") is not None]
    if not calls or "encoder" not in run.info:
        return None
    h, i, n_l = run.info["encoder"]
    per_token = peaks.encoder_flops_per_token(h, i, n_l, run.info["seq_len"])
    rows = sum(c.counts["recompute_fraction"] * run.info["rows"] * c.queries for c in calls)
    tokens = rows * run.info["mean_row_tokens"] + sum(c.counts["query_tokens"] for c in calls)
    return 100.0 * tokens * per_token / (seconds * peaks.BF16_TC_FLOPS_PER_S)
