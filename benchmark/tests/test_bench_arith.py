"""The benchmark's arithmetic on synthetic inputs."""

import math

import numpy as np
import pytest

from benchmark.harness import checks, peaks, runner, spec, stats, trace


def calls(latencies, queries=1, gap=0.0):
    out, t = [], 0.0
    for lat in latencies:
        out.append(stats.CallRecord(t, t + lat, queries))
        t += lat + gap
    return out


def test_qps_takes_all_queries_over_the_whole_window():
    c = calls([0.5, 0.25, 0.25], queries=64, gap=0.5)
    assert stats.window_seconds(c) == pytest.approx(2.0)
    assert stats.qps(c) == pytest.approx(3 * 64 / 2.0)


def test_p95_over_every_call():
    c = calls([i / 1000 for i in range(1, 101)])
    assert stats.p95_ms(c) == pytest.approx(np.percentile(np.arange(1, 101), 95))


def test_recall_counts_reference_ids_found():
    ids = np.array([[1, 2, 3], [4, 5, 6]])
    true = np.array([[3, 2, 9], [7, 8, 9]])
    assert stats.recall_at_k(ids, true) == pytest.approx(2 / 6)
    assert stats.recall_at_k(np.full((1, 3), -1), np.array([[-1, 2, 3]])) == 0.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_seconds(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, -1, 7) == [(-1, 0), (3, 5), (6, 7)]


def test_idle_share_is_a_union_not_a_sum_and_gaps_carry_open_spans():
    device = [(10, 20, "a"), (15, 25, "b"), (40, 50, "a")]
    notes = [(0, 100, "call"), (20, 45, "search"), (24, 38, "embed")]
    s = trace.summarize(device, notes, 0, 100)
    assert s.busy_s == pytest.approx(25e-6)  # a sum of self times would say 30
    assert s.window_s == pytest.approx(100e-6)
    assert s.ops["a"] == (2, pytest.approx(20e-6))
    assert s.idle["call"] == pytest.approx((10 + 50) * 1e-6)
    assert s.idle["call/search/embed"] == pytest.approx(15e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "a" and len(b["idle_gaps"]) == 2
    assert spec.load_reader("device_idle_pct.batch").read(_run(s)) == pytest.approx(75.0)


@pytest.mark.parametrize("name", ["device_idle_pct", "recall_at_10"])
def test_a_single_cells_metric_reads_as_its_batch_twin(name):
    """The `.single` readers, split off for their own cells and bounds,
    read what the metric they re-export reads."""
    s = trace.TraceSummary(window_s=1.0, busy_s=0.25, ops={}, idle={})
    twin = f"{name}.batch" if name == "device_idle_pct" else name
    want = spec.load_reader(twin).read(_run(s))
    assert spec.load_reader(f"{name}.single").read(_run(s)) == pytest.approx(want)


def _run(summary=None, calls_=(), info=None, spans=None, window_s=1.0):
    return runner.Run(setup_s=1.0, build_s=2.0, build_rows=100,
                      calls=list(calls_), window_s=window_s, recall=0.5, spans=spans or {},
                      info=info or {}, trace=summary)


def test_k1_bytes_bound_at_the_headline_shape():
    t, kind = peaks.hop_merge_bound_s(4096, 120, 64, 16)
    assert kind == "bytes"
    assert t == pytest.approx(4096 * ((120 + 64) * 8 + (16 + 64) * 8) / 3.35e12)
    assert t * 1e3 == pytest.approx(0.00258, rel=0.01)
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5, ops={"void hop_merge_warp_kernel<256, 512>":
                                                       (10, 10 * 2 * t)}, idle={})
    got = spec.load_reader("k1_roofline_pct").read(_run(s, info={"hop_merge_shape": (4096, 120, 64, 16)}))
    assert got == pytest.approx(50.0)
    assert spec.load_reader("k1_roofline_pct").read(_run(trace.TraceSummary(1.0, 0.5, {}, {}),
                                                         info={"hop_merge_shape": (1, 1, 1, 1)})) is None


def test_encoder_flops_per_token_for_minilm_l6():
    # 6 layers x 1,774,464 parameters, times 2, plus 4 x 64 x 384 x 6.
    assert peaks.bert_layer_params(384, 1536) == 1_774_464
    assert peaks.encoder_flops_per_token(384, 1536, 6, 64) == 2 * 6 * 1_774_464 + 4 * 64 * 384 * 6


def test_step_mfu_counts_the_gates_rows_and_the_query_tokens():
    c = [stats.CallRecord(0.0, 0.5, 64, {"recompute_fraction": 0.01, "query_tokens": 3000}),
         stats.CallRecord(0.5, 1.0, 64, {"recompute_fraction": 0.02, "query_tokens": 3200})]
    info = {"encoder": (384, 1536, 6), "seq_len": 64, "rows": 1000, "mean_row_tokens": 48.0}
    per_token = peaks.encoder_flops_per_token(384, 1536, 6, 64)
    rows = (0.01 + 0.02) * 1000 * 64
    want = 100 * (rows * 48 + 6200) * per_token / (1.0 * 989e12)
    assert spec.load_reader("step_mfu_pct").read(_run(calls_=c, info=info)) == pytest.approx(want)
    assert spec.load_reader("recompute_fraction").read(_run(calls_=c)) == pytest.approx(0.015)


def test_bad_rows_and_verdict():
    a = checks.gather([(np.array([0, 1]), np.array([[1.0, 2.0], [1.0, 0.5]]),
                        np.array([[3, 4], [5, 6]])),
                       (np.array([2, 3]), np.array([[1.0, 2.0]]), np.array([[7, 7]]))], k=2)
    assert a.ids.shape == (4, 2) and a.ids[3, 0] == -1
    assert checks.bad_rows(a, n=10).tolist() == [False, True, True, True]
    ok, shown = checks.verdict(0, {"x": 1e-6}, {"x": 1e-5})
    assert ok and list(shown) == ["bad_answers", "x"]
    assert not checks.verdict(1, {"x": 1e-6}, {"x": 1e-5})[0]
    assert not checks.verdict(0, {"x": 1e-4}, {"x": 1e-5})[0]
    assert not checks.verdict(0, {}, {"x": 1e-5})[0]
    assert not checks.verdict(0, {"x": math.nan}, {"x": 1e-5})[0]

