"""mb_attn_roofline_pct: the varlen attention kernel's least time for the
attention work of the segments handed to the encoder in the profiled calls
(the query chunks and every row `embed` re-encoded, their lengths from the
driver's own table; `harness/modernbert_work.attention_bound_s`: per layer
the larger of 4 x h x pairs FLOPs at 989 TFLOP/s and q, k, v read and the
output written once at 3.35 TB/s), over the kernel's device time under its
trace name in the traced slice."""

KERNEL = "varlen_attn"


def read(run):
    t = run.trace
    if t is None:
        return None
    launches, seconds = t.op_time(KERNEL)
    calls = [c for c in run.calls if c.profiled and "attn_bound_s" in c.counts]
    if launches == 0 or seconds <= 0 or not calls:
        return None
    return 100.0 * sum(c.counts["attn_bound_s"] for c in calls) / seconds
