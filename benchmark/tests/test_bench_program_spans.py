"""The trace's idle labels with the program's own spans (utils/tracing
regions, opened as record_function ranges) nested under the harness's."""

import pytest

from benchmark.harness import trace

ROOT = "call/search/stored.search"
HOP = f"{ROOT}/search.hop"
HARNESS = {"call", "search"}

# One call holding one traced search of two hops (microseconds): routing,
# each hop a sync then an expand, and the final rescore.
NOTES = [(0, 100, "call"), (10, 90, "search"), (11, 89, "stored.search"),
         (12, 20, "search.route"),
         (20, 40, "search.hop"), (22, 30, "search.hop.sync"), (31, 38, "search.hop.expand"),
         (40, 60, "search.hop"), (42, 50, "search.hop.sync"), (51, 58, "search.hop.expand"),
         (60, 88, "search.final")]
# The device: work before the search, the route's kernel, each hop's
# condition and expand kernels, the final rescore's, the answers' copy.
DEVICE = [(0, 10, "encode"), (12, 14, "route"), (21, 22, "cond"), (31, 32, "expand"),
          (41, 42, "cond"), (51, 52, "expand"), (60, 61, "final"), (88, 100, "copy")]


def test_program_spans_under_call_search_label_the_idle_gaps():
    s = trace.summarize(DEVICE, NOTES, 0, 100)
    assert s.busy_s == pytest.approx(29e-6)
    assert s.idle == pytest.approx({
        "call/search": 2e-6,
        f"{ROOT}/search.route": 7e-6,
        f"{HOP}/search.hop.sync": 18e-6,
        f"{HOP}/search.hop.expand": 17e-6,
        f"{ROOT}/search.final": 27e-6})
    assert sum(s.idle.values()) == pytest.approx(s.window_s - s.busy_s)


def test_without_the_program_spans_the_same_idle_is_one_label():
    harness_only = [n for n in NOTES if n[2] in HARNESS]
    s = trace.summarize(DEVICE, harness_only, 0, 100)
    assert s.idle == pytest.approx({"call/search": 71e-6})
