"""moe_gemm_roofline_pct: the expert step's least time for the expert work
of the segments handed to the encoder in the profiled calls (the query
chunks and every row `embed` re-encoded, their lengths from the driver's
own table, each call one forward; `harness/moe_work.experts_bound_s`: per
layer the larger of 6 x A x h x i FLOPs at 989 TFLOP/s and the routed
experts' weights, the tokens' rows, the permuted intermediate and the
weighted rows moved once at 3.35 TB/s), over the device time of the
expert step's kernels in the traced slice: the port's passes, whose trace
names begin with "moe_gemm", and the grouped GEMM's, whose names hold
"group" in any case (PyTorch's `_grouped_mm` kernel and the one that lays
out its problems). None when the slice holds no grouped kernel, so the
passes' time alone is never read as the step's."""

PASSES = "moe_gemm"
GROUPED = "group"


def read(run):
    t = run.trace
    if t is None:
        return None
    passes = [s for k, (_, s) in t.ops.items() if PASSES in k]
    grouped = [s for k, (_, s) in t.ops.items() if GROUPED in k.lower() and PASSES not in k]
    calls = [c for c in run.calls if c.profiled and "moe_bound_s" in c.counts]
    seconds = sum(passes) + sum(grouped)
    if not passes or not grouped or seconds <= 0 or not calls:
        return None
    return 100.0 * sum(c.counts["moe_bound_s"] for c in calls) / seconds
