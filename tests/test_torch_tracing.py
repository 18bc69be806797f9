"""The port's hot-path tracing (utils/tracing: `region`, `count`, the record
buffer) and the spans and counters it places inside the search, on the CPU.

Off, a region is one shared no-op: no clock read, no profiler range, no
record. On, a search is one root region whose descendants share its request
id, `search.hops` counts the loop's body runs, and the answers are the
same, bit for bit, as with tracing off."""

import threading

import numpy as np
import pytest
import torch

from islands_tpu_torch.core import search as search_mod
from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.models import TextEncoder
from islands_tpu_torch.models import provider as provider_mod
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider
from islands_tpu_torch.utils import tracing

from conftest import make_vectors

N, DIM, NQ = 1024, 16, 24
ROWS, SEQ = 256, 16

# StoredSearcher.search knobs: the sketch gate (both hop-merge routes, the
# freeze loop and the static loop, with and without a final rescore) and
# the exact gate.
STORED = {
    "sketch-inline": dict(gate="sketch", ef=32, promote_width=16, max_iters=12,
                          expand_width=2, final_rescore=64),
    "sketch-fused": dict(gate="sketch", ef=32, promote_width=16, max_iters=12,
                         expand_width=2, final_rescore=64, hop_merge="fused"),
    "sketch-static": dict(gate="sketch", ef=32, promote_width=8, max_iters=6,
                          expand_width=2, static_loop=True),
    "sketch-long": dict(gate="sketch", ef=16, promote_width=8, max_iters=200),
    "exact": dict(gate="exact", ef=32),
}
LEANN = {"sketch": dict(gate="sketch", ef=32), "none": dict(gate="none", ef=16)}

ROOT_CHILDREN = {"search.route", "search.hop", "search.final"}
HOP_CHILDREN = {"search.hop.sync", "search.hop.expand", "search.hop.merge",
                "search.hop.rescore"}


@pytest.fixture(autouse=True)
def tracing_reset():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def stored():
    x = make_vectors(N, DIM, seed=71)
    q = torch.as_tensor(make_vectors(NQ, DIM, seed=72))
    cfg = LeannConfig(metric=DistanceMetric.EUCLIDEAN, m=8, m0=16, reverse_slack=16,
                      wave_size=256, ef_construction=32, sketch_dims=16)
    graph, sketch = build_index_with_sketch(x, cfg, device="cpu")
    return StoredSearcher(graph, x, cfg.metric, sketch=sketch, routing_size=64,
                          device="cpu"), q


@pytest.fixture(scope="module")
def leann():
    rng = np.random.default_rng(5)
    protos = rng.integers(1, 1024, size=(16, SEQ))
    ids = protos[rng.integers(0, 16, size=ROWS)]
    noise = rng.random(ids.shape) < 0.3
    ids[noise] = rng.integers(1, 1024, size=int(noise.sum()))
    lens = rng.integers(SEQ // 2, SEQ + 1, size=ROWS)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
    enc = TextEncoder.from_preset("tiny-test", seed=0, device="cpu")
    prov = EncoderEmbeddingProvider(enc, (ids * mask).astype(np.int32), mask).with_center(
        sample=64, batch=32)
    cfg = LeannConfig(m=8, m0=16, ef_construction=32, wave_size=64, reverse_slack=8,
                      sketch_query=True, routing_size=64)
    index = LeannIndex(cfg, device="cpu").build(prov, num_vectors=ROWS)
    q = prov.embed(torch.arange(0, ROWS, 16))
    return index, prov, q


def _by_id(records):
    return {r.id: r for r in records}


def _counter(records, name):
    return sum((r.counts or {}).get(name, 0) for r in records)


def _check_tree(records, root_name):
    """One root named `root_name`; every record shares its request id and
    hangs from a record of the same search."""
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == [root_name]
    root, ids = roots[0], _by_id(records)
    for r in records:
        assert r.request == root.request
        assert r.t0 <= r.t1
        if r.parent is not None:
            up = ids[r.parent]
            assert up.t0 <= r.t0 and r.t1 <= up.t1
    return root, ids


# -- off -------------------------------------------------------------------


def test_off_region_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("an off region touched the clock, the profiler or a device")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(tracing.time, "perf_counter", refuse)
    assert not tracing.enabled()
    assert tracing.region("a") is tracing.region("b")
    with tracing.region("a"):
        tracing.count("n", 3)
    assert tracing.snapshot() == {"records": [], "counters": {}, "dropped": 0}


def test_off_region_leaves_nothing_in_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.region("search.hop"):
            tracing.count("search.hops", 1)
    assert not [e for e in prof.events() if e.name == "search.hop"]


@pytest.mark.parametrize("knobs", list(STORED), ids=list(STORED))
def test_off_search_records_nothing(stored, knobs, monkeypatch):
    searcher, q = stored
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: opened.append(name) or real(name, *a))
    searcher.search(q, k=10, **STORED[knobs])
    assert opened == []
    assert tracing.snapshot() == {"records": [], "counters": {}, "dropped": 0}


# -- on: the stored search ---------------------------------------------------


@pytest.mark.parametrize("knobs", list(STORED), ids=list(STORED))
def test_stored_search_is_one_traced_request(stored, knobs, monkeypatch):
    searcher, q = stored
    kw = STORED[knobs]
    bodies = []
    pop = search_mod._pop
    monkeypatch.setattr(search_mod, "_pop", lambda *a: bodies.append(1) or pop(*a))
    tracing.enable()
    searcher.search(q, k=10, **kw)
    tracing.disable()
    snap = tracing.snapshot()
    recs = snap["records"]
    root, ids = _check_tree(recs, "stored.search")
    assert snap["dropped"] == 0
    assert _counter(recs, "search.hops") == len(bodies) > 0
    assert snap["counters"] == {"search.hops": len(bodies)}
    hops = [r for r in recs if r.name == "search.hop"]
    syncs = [r for r in recs if r.name == "search.hop.sync"]
    for r in recs:
        if r.name in ROOT_CHILDREN:
            assert r.parent == root.id
        elif r.name in HOP_CHILDREN:
            assert ids[r.parent].name == "search.hop"
        else:
            assert r is root
    # the counter sits on the hop's own record, one per body run
    assert all((r.counts or {}).get("search.hops", 0) <= 1 for r in hops)
    if kw.get("static_loop"):
        assert syncs == [] and len(hops) == len(bodies) == kw["max_iters"]
    else:
        assert sorted(s.parent for s in syncs) == sorted(h.id for h in hops)
    if kw["gate"] == "sketch":
        names = [r.name for r in recs]
        assert names.count("search.route") == names.count("search.final") == 1
        for child in ("search.hop.expand", "search.hop.merge", "search.hop.rescore"):
            assert names.count(child) == len(bodies)


@pytest.mark.parametrize("profiled", [False, True], ids=["no profiler", "profiler"])
def test_on_regions_are_profiler_ranges_only_under_a_profiler(stored, profiled, monkeypatch):
    searcher, q = stored
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: opened.append(name) or real(name, *a))
    tracing.enable()
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            searcher.search(q, k=10, **STORED["sketch-fused"])
    else:
        searcher.search(q, k=10, **STORED["sketch-fused"])
    names = sorted(r.name for r in tracing.snapshot()["records"])
    assert sorted(opened) == (names if profiled else [])
    if profiled:
        ranges = sorted(e.name for e in prof.events() if e.name in set(names))
        assert ranges == names


def test_freeze_loop_stops_after_its_last_body(stored):
    # With room to spare the loop ends on a pass that reads `any()` false
    # and runs no body: one more hop (and sync) record than hops counted.
    searcher, q = stored
    tracing.enable()
    searcher.search(q, k=10, **STORED["sketch-long"])
    recs = tracing.snapshot()["records"]
    hops = [r for r in recs if r.name == "search.hop"]
    assert len(hops) == _counter(recs, "search.hops") + 1 < 200
    assert "search.hops" not in (hops[-1].counts or {})


def test_requests_are_per_search_and_per_thread(stored):
    searcher, q = stored
    tracing.enable()
    searcher.search(q[:4], k=5, **STORED["sketch-inline"])
    t = threading.Thread(target=lambda: searcher.search(q[4:8], k=5, **STORED["exact"]))
    t.start()
    t.join()
    searcher.search(q[8:12], k=5, **STORED["sketch-fused"])
    recs = tracing.snapshot()["records"]
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["stored.search"] * 3
    assert len({r.request for r in roots}) == 3
    for root in roots:
        _check_tree([r for r in recs if r.request == root.request], "stored.search")


# -- on: the recompute search ------------------------------------------------


def test_leann_counts_exact_rows_and_provider_rows(leann, monkeypatch):
    index, prov, q = leann
    encoded, n_exact = [], []
    enc = provider_mod.encode
    monkeypatch.setattr(provider_mod, "encode",
                        lambda model, ids, *a: encoded.append(ids.shape[0]) or enc(model, ids, *a))
    gated = search_mod.batched_sketch_gated_query

    def keep_counts(*a, **kw):
        out = gated(*a, **kw)
        n_exact.append(out[2].clone())
        return out

    monkeypatch.setattr("islands_tpu_torch.core.leann.batched_sketch_gated_query", keep_counts)
    tracing.enable()
    index.search(q, k=5, provider=prov, **LEANN["sketch"])
    snap = tracing.snapshot()
    recs = snap["records"]
    root, ids = _check_tree(recs, "leann.search")
    assert root.counts == {"search.exact_rows": int(n_exact[0].sum())}
    assert _counter(recs, "provider.rows") == sum(encoded) == snap["counters"]["provider.rows"]
    assert 0 < int(n_exact[0].sum()) <= sum(encoded)
    embeds = [r for r in recs if r.name == "provider.embed"]
    forwards = [r for r in recs if r.name == "encoder.forward"]
    assert len(forwards) == len(encoded) >= len(embeds) > 0
    assert {ids[r.parent].name for r in forwards} == {"provider.embed"}
    assert {ids[r.parent].name for r in embeds} == {"search.route", "search.hop.rescore"}
    assert index.last_recompute_fraction == (
        float(n_exact[0].float().mean()) / index.num_nodes)


def test_encode_tokens_is_a_root_forward(leann):
    _, prov, _ = leann
    tracing.enable()
    prov.encoder.encode_tokens(prov.token_ids[:4], prov.token_mask[:4])
    recs = tracing.snapshot()["records"]
    assert [(r.name, r.parent) for r in recs] == [("encoder.forward", None)]


# -- the buffer, counters, span ------------------------------------------------


@pytest.mark.parametrize("limit,opened", [(1, 4), (5, 5), (5, 8), (64, 100)])
def test_buffer_drops_beyond_its_bound(limit, opened, monkeypatch):
    monkeypatch.setattr(tracing, "RECORD_LIMIT", limit)
    tracing.enable()
    for i in range(opened):
        with tracing.region(f"r{i}"):
            pass
    snap = tracing.snapshot()
    assert [r.name for r in snap["records"]] == [f"r{i}" for i in range(min(limit, opened))]
    assert snap["dropped"] == max(opened - limit, 0)
    tracing.reset()
    assert tracing.snapshot() == {"records": [], "counters": {}, "dropped": 0}


def test_counts_go_to_the_innermost_open_region():
    tracing.enable()
    tracing.count("loose", 2)
    with tracing.region("outer"):
        tracing.count("a", 1)
        with tracing.region("inner"):
            tracing.count("a", 2)
            tracing.count("b", 5)
        tracing.count("a", 4)
    inner, outer = tracing.snapshot()["records"]
    assert (inner.name, inner.counts, inner.parent) == ("inner", {"a": 2, "b": 5}, outer.id)
    assert (outer.name, outer.counts, outer.parent) == ("outer", {"a": 5}, None)
    assert tracing.snapshot()["counters"] == {"loose": 2, "a": 7, "b": 5}


def test_threads_keep_their_own_requests_and_lose_no_count():
    import sys

    threads, per = 16, 200
    tracing.enable()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with tracing.region("root"):
                    with tracing.region("child"):
                        tracing.count("n", 1)
        pool = [threading.Thread(target=work) for _ in range(threads)]
        [t.start() for t in pool]
        [t.join(timeout=60) for t in pool]
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(saved)
    snap = tracing.snapshot()
    recs = snap["records"]
    assert len(recs) == 2 * threads * per and snap["counters"] == {"n": threads * per}
    ids = _by_id(recs)
    children = [r for r in recs if r.name == "child"]
    assert all(ids[r.parent].name == "root" and ids[r.parent].request == r.request
               and r.counts == {"n": 1} for r in children)
    assert len({r.request for r in recs}) == threads * per


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_span_keeps_its_timing_and_records_when_on(on):
    tracing.metrics.reset()
    if on:
        tracing.enable()
    with tracing.region("outer"):
        with tracing.span("spanned", block_on=torch.zeros(2)):
            pass
    assert tracing.metrics.snapshot()["timings"]["spanned"]["count"] == 1
    names = [(r.name, r.parent is not None) for r in tracing.snapshot()["records"]]
    assert names == ([("spanned", True), ("outer", False)] if on else [])


def test_metrics_timings_keep_a_count_and_total_not_samples():
    m = tracing.Metrics()
    for _ in range(1000):
        m.record_timing("hop", 0.25)
    assert m.timings["hop"] == [1000, 250.0]
    assert m.snapshot()["timings"]["hop"] == {"count": 1000, "total_s": 250.0, "mean_s": 0.25}


# -- answers, on against off ---------------------------------------------------


def _same(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("knobs", list(STORED), ids=list(STORED))
def test_stored_answers_identical_on_and_off(stored, knobs):
    searcher, q = stored
    off = searcher.search(q, k=10, **STORED[knobs])
    tracing.enable()
    on = searcher.search(q, k=10, **STORED[knobs])
    _same(off, on)
    assert tracing.snapshot()["records"]


@pytest.mark.parametrize("gate", list(LEANN))
def test_leann_answers_identical_on_and_off(leann, gate):
    index, prov, q = leann
    off = index.search(q, k=5, provider=prov, **LEANN[gate])
    frac_off = index.last_recompute_fraction
    tracing.enable()
    on = index.search(q, k=5, provider=prov, **LEANN[gate])
    _same(off, on)
    assert index.last_recompute_fraction == frac_off
