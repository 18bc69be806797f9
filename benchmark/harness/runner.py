"""One run of one cell: set-up, the measured window, the check, the metrics.

The loop is closed with one client: the next call starts when the last has
returned its answers to the host. The window runs from the first call's
start to the end of the call that crosses `seconds`. Nothing is built or
compiled inside it: set-up has already driven the cell's own shapes.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from benchmark.harness import checks, spec, stats, trace


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    build_s: float
    build_rows: int
    calls: list  # stats.CallRecord, the window's calls in order
    window_s: float
    recall: float
    spans: dict  # harness span name -> seconds inside the window, outside the profiled slice
    info: dict  # the driver's shapes and counts (see each driver)
    trace: trace.TraceSummary | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float | None = None) -> dict:
    """Returns the result line's fields, `checks` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    traffic = cell.traffic
    spans = trace.Spans(traced, device)
    drv = spec.load_driver(cell).Driver(cell.config, traffic, seed, device, spans)
    log(f"set-up import and init: {time.perf_counter() - t_start:.3f} s")

    def part(name, fn):
        """Runs one part of set-up to a synchronise; (its result, seconds)."""
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        took = time.perf_counter() - t0
        log(f"set-up {name}: {took:.3f} s")
        return out, took

    part("data", drv.make_inputs)
    part("weights", drv.make_weights)
    rows, build_s = part("build", drv.build)
    part("compile", drv.compile)

    def warm():
        for _ in range(int(traffic["warm_calls"])):
            drv.call(drv.next_call())

    part("warm-up", warm)
    if traced:
        def warm_profiler():
            cap = trace.Capture(device)
            cap.start()
            drv.call(drv.next_call())
            cap.stop()
        part("profiler warm-up", warm_profiler)
    setup_s = time.perf_counter() - t_start
    log(f"set-up total: {setup_s:.3f} s")

    calls, answers = [], []
    cap, cap_open = None, False
    trace_at = min(float(traffic["trace_start"]), 0.5 * seconds)
    spans.active = drv.recording = True
    w0 = None
    while True:
        sel = drv.next_call()
        t0 = time.perf_counter()
        w0 = t0 if w0 is None else w0
        with spans.span("call"):
            d, ids, counts = drv.call(sel)
        t1 = time.perf_counter()
        calls.append(stats.CallRecord(t0, t1, len(sel[0]), counts, profiled=cap_open))
        answers.append((sel[0], d, ids))
        if traced and cap is None and t1 - w0 >= trace_at:
            cap = trace.Capture(device)
            cap.start()
            cap_open, cap_t0 = True, t1
            spans.active = False
        elif cap_open and t1 - cap_t0 >= float(traffic["trace_seconds"]):
            cap.stop()
            cap_open, spans.active = False, True
        if t1 - w0 >= seconds:
            break
    spans.active = drv.recording = False
    if cap_open:
        cap.stop()
    window_s = stats.window_seconds(calls)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"window: {len(calls)} calls, {sum(c.queries for c in calls)} queries in {window_s:.3f} s")

    summary = None
    if cap is not None:
        t0 = time.perf_counter()
        summary = cap.summary(spans.names)
        log(f"trace reading: {time.perf_counter() - t0:.3f} s")
    drv.release()
    t0 = time.perf_counter()
    got = checks.gather(answers, int(traffic["k"]))
    bad = checks.bad_rows(got, drv.rows)
    recall, numbers = drv.check(got, bad)
    log(f"reference check: {time.perf_counter() - t0:.3f} s")
    correct, shown = checks.verdict(int(bad.sum()), numbers, cell.limits)

    run = Run(setup_s=setup_s, build_s=build_s,
              build_rows=rows, calls=calls, window_s=window_s, recall=recall,
              spans=dict(spans.totals), info=drv.info, trace=summary)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_reader(m["name"], cell.bench_dir).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(len(bad)), "failed": int(bad.sum()),
           "metrics": metrics, "device": dev}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = shown
    return out


def format_checks(shown: dict) -> list[str]:
    return [f"check {name}: {v['value']!r} (limit {v['limit']!r})" for name, v in shown.items()]
