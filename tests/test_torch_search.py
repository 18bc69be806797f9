"""Search of the PyTorch port against the JAX package, on the reference's own
graph and sketch (built by islands_tpu, carried across with
islands_tpu_torch.convert).

Tolerances: at every rung of bench.py's ladder, for the sketch gate (fused
and inline hop-merge) and the exact gate,
- ids identical on >= 98% of query rows (an f32 near-tie between XLA's and
  torch's summation orders may flip one promotion),
- distances within 1e-5 on the rows whose ids agree,
- recall@10 within 0.005.
The port's fused and inline paths must be bit-identical. The two-level loop
is held to the reference on the metrics other than config 4's euclidean
(tests/test_torch_leann.py has euclidean) with the same id tolerance."""

import threading

import numpy as np
import pytest
import torch

from islands_tpu.core.build import build_index_with_sketch as jax_build
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.config import PQConfig as JPQConfig
from islands_tpu.core.embedding import InMemoryEmbeddingProvider as JProvider
from islands_tpu.core.leann import LeannIndex as JIndex
from islands_tpu.core.search import StoredSearcher as JSearcher
from islands_tpu.ops import distance as jd
from islands_tpu_torch.convert import graph_from_numpy, leann_from_numpy, sketch_from_numpy
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.config import PQConfig as TPQConfig
from islands_tpu_torch.core import search as search_mod
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.utils.graphs import GraphCache
from islands_tpu_torch.utils import tracing

from conftest import make_vectors
from torch_graph_capture import EagerCapture

N, DIM, NQ = 2048, 32, 64
# bench.py's primary rungs (ef, promote, max_iters, expand_width,
# final_rescore), then the exact gate.
RUNGS = {
    "p8/i12/fr64": dict(gate="sketch", ef=32, promote_width=8, max_iters=12,
                        expand_width=2, final_rescore=64),
    "p16/i12/fr64": dict(gate="sketch", ef=32, promote_width=16, max_iters=12,
                         expand_width=2, final_rescore=64),
    "p24/i12/fr64": dict(gate="sketch", ef=32, promote_width=24, max_iters=12,
                         expand_width=2, final_rescore=64),
    "p48/i10": dict(gate="sketch", ef=32, promote_width=48, max_iters=10,
                    expand_width=2),
    "p64/x4": dict(gate="sketch", ef=32, promote_width=64, max_iters=10,
                   expand_width=4),
    "exact-ef64": dict(gate="exact", ef=64),
}

# Every rung on euclidean (bench.py's metric); cosine at the headline rung
# and the exact gate, to keep the file's JAX compiles few.
CASES = [("euclidean", r) for r in RUNGS] + [("cosine", "p16/i12/fr64"),
                                             ("cosine", "exact-ef64")]


@pytest.fixture(scope="module")
def setups():
    """metric -> reference graph + sketch, both searchers, ground truth."""
    cache = {}

    def get(metric):
        if metric not in cache:
            cache[metric] = _setup(metric)
        return cache[metric]

    return get


def _setup(metric):
    x = make_vectors(N, DIM, seed=61)
    q = make_vectors(NQ, DIM, seed=62)
    cfg = JConfig(metric=JM(metric), m=8, m0=16, reverse_slack=16,
                  wave_size=256, ef_construction=32, sketch_dims=16)
    jg, js = jax_build(x, cfg)
    graph = graph_from_numpy(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                             np.asarray(jg.levels), int(jg.entry_point),
                             int(jg.max_level), device="cpu")
    sketch = sketch_from_numpy(np.asarray(js.w), np.asarray(js.scale),
                               np.asarray(js.node_sketch),
                               np.asarray(js.nbr_sketch), device="cpu")
    _, tids = jd.brute_force_topk(q, x, 10, JM(metric))
    return dict(
        x=x, q=q, tids=np.asarray(tids),
        ref=JSearcher(jg, x, JM(metric), sketch=js, routing_size=512),
        port=StoredSearcher(graph, x, TM(metric), sketch=sketch,
                            routing_size=512, device="cpu"))


def _recall(ids, tids):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(ids, tids)])


@pytest.mark.parametrize("metric,rung", CASES)
def test_search_matches_reference(setups, metric, rung):
    s = setups(metric)
    kw = RUNGS[rung]
    jd_, ji = s["ref"].search(s["q"], k=10, hop_merge="fused", **kw)
    jd_, ji = np.asarray(jd_), np.asarray(ji)
    for mode in ("fused", "inline"):
        td_, ti = s["port"].search(torch.from_numpy(s["q"]), k=10, hop_merge=mode, **kw)
        td_, ti = td_.numpy(), ti.numpy()
        same = np.all(ti == ji, axis=1)
        assert same.mean() >= 0.98, (mode, same.mean())
        np.testing.assert_allclose(td_[same], jd_[same], rtol=0, atol=1e-5)
        assert abs(_recall(ti, s["tids"]) - _recall(ji, s["tids"])) <= 0.005


@pytest.mark.parametrize("kw", [
    dict(k=10, ef=32, gate="sketch", promote_width=8),
    dict(k=10, ef=32, gate="sketch", promote_width=16, max_iters=6, final_rescore=32),
    dict(k=5, ef=16, gate="sketch", promote_width=4, expand_width=2),
    dict(k=10, ef=32, gate="sketch", promote_width=12, static_loop=True, aq_width=96),
])
def test_fused_and_inline_are_bit_identical(setups, kw):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"])
    d_i, ids_i = s["port"].search(q, **kw, hop_merge="inline")
    d_f, ids_f = s["port"].search(q, **kw, hop_merge="fused")
    assert torch.equal(ids_i, ids_f)
    assert torch.equal(d_i, d_f)


def test_static_loop_matches_reference(setups):
    s = setups("euclidean")
    kw = dict(RUNGS["p16/i12/fr64"], static_loop=True, aq_width=96)
    _, ji = s["ref"].search(s["q"], k=10, hop_merge="inline", **kw)
    _, ti = s["port"].search(torch.from_numpy(s["q"]), k=10, hop_merge="inline", **kw)
    assert np.mean(np.all(ti.numpy() == np.asarray(ji), axis=1)) >= 0.98


@pytest.mark.parametrize("metric", ["cosine", "dotproduct", "manhattan"])
def test_two_level_loop_matches_reference_on_other_metrics(metric):
    # batched_two_level_search through LeannIndex on the reference's index
    # (tests/test_torch_leann.py covers euclidean, config 4's metric).
    # Distances: rtol 1e-6 on top of atol 1e-5, since dot products and L1
    # sums here reach ~100, where an f32 ulp is ~8e-6.
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((32, 32)).astype(np.float32)
    x = (centres[rng.integers(0, 32, 1200)] + 1.2 * rng.standard_normal((1200, 32)))
    q = (centres[rng.integers(0, 32, 64)] + 1.2 * rng.standard_normal((64, 32)))
    x, q = x.astype(np.float32), q.astype(np.float32)
    small = dict(m=8, m0=16, ef_construction=48, wave_size=256, intra_wave_k=8,
                 reverse_slack=16)
    pq = dict(num_subquantizers=8, num_centroids=64, training_iterations=6, seed=0)
    ref = JIndex(JConfig(metric=JM(metric), **small))
    ref.build_from_embeddings(x, with_pq=JPQConfig(**pq))
    g = ref.graph
    port = leann_from_numpy(
        TConfig(metric=TM(metric), **small), 32,
        graph=dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                   levels=np.asarray(g.levels), entry_point=int(g.entry_point),
                   max_level=int(g.max_level)),
        pq=dict(centroids=np.asarray(ref.pq.codebook.centroids),
                codes=np.asarray(ref.pq_codes), pq_config=TPQConfig(**pq)),
        device="cpu")
    jprov, tprov = JProvider(x), InMemoryEmbeddingProvider(x, device="cpu")
    kw = dict(ef=32, rerank_ratio=0.25, routing_size=128, expand_width=2, max_iters=12,
              promote_width=8, final_rescore=16, hop_merge="fused")
    for search, args in (("search_two_level", kw), ("search_pq_scan", dict(rerank=32))):
        jd_, ji = (np.asarray(a) for a in getattr(ref, search)(q, k=10, provider=jprov, **args))
        td_, ti = (a.numpy() for a in getattr(port, search)(torch.from_numpy(q), k=10,
                                                            provider=tprov, **args))
        same = np.all(ti == ji, axis=1)
        assert same.mean() >= 0.98, (search, same.mean())
        np.testing.assert_allclose(td_[same], jd_[same], rtol=1e-6, atol=1e-5)
        assert port.last_recompute_fraction == ref.last_recompute_fraction


def test_empty_graph_returns_empty():
    from islands_tpu_torch.core.csr import CsrGraph

    s = StoredSearcher(CsrGraph.empty(0, 4, device="cpu"), np.zeros((0, 8), np.float32),
                       TM.EUCLIDEAN, device="cpu")
    d, ids = s.search(np.zeros((3, 8), np.float32), k=5)
    assert d.shape == (3, 0) and ids.shape == (3, 0)


def test_bad_knobs_raise(setups):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"][:2])
    with pytest.raises(ValueError):
        s["port"].search(q, k=10, gate="sketch", hop_merge="nope")
    with pytest.raises(ValueError):
        s["port"].search(q, k=10, gate="nope")


# -- the hop loop's order and the graphed route ------------------------------
#
# `_run_hops` reads, before the first hop, `cond`'s any() of the first state
# and then the flag each hop leaves for the next. `_loop_before` is the loop
# as it read before: cond and any() at the head of every pass. Both must give
# the same state, run the body and cond as often and read the host as often.


def _loop_before(cond, body, state, max_iters):
    for _ in range(max_iters):
        active = cond(state)
        if not bool(active.any()):
            break
        search_mod.count("search.hops", 1)
        new = body(state)
        state = tuple(torch.where(active.view(-1, *([1] * (o.dim() - 1))), nw, o)
                      for nw, o in zip(new, state))
    return state


def _toy_loop(limits, calls):
    """A [B] counter that hops until it reaches its row's limit, and a [B, 3]
    trail of what the body saw; `calls` counts cond and body runs."""
    limits = torch.as_tensor(limits)

    def cond(state):
        calls["cond"] += 1
        return state[0] < limits

    def body(state):
        calls["body"] += 1
        x, trail = state
        return x + 1, trail * 2 + x[:, None]

    state = (torch.zeros_like(limits), torch.zeros((len(limits), 3), dtype=torch.int64))
    return cond, body, state


@pytest.mark.parametrize("limits,max_iters", [
    ([3, 3, 3], 10),          # every row stops before max_iters
    ([4, 4], 4),              # the last hop is the last allowed one
    ([5, 5], 4),              # still active when max_iters runs out
    ([2, 7], 1),              # max_iters = 1
    ([0, 0, 0], 5),           # nothing to do: one read, no hop
    ([1, 6, 3, 0, 9], 7),     # rows freeze at different hops
    ([2, 2], 0),              # no pass at all
], ids=["early", "exact-max", "cut-at-max", "one-hop", "none-active", "ragged",
        "zero-iters"])
def test_run_hops_keeps_the_loop_before_it(limits, max_iters):
    runs = {}
    for name, loop in (("before", lambda c, b, s: _loop_before(c, b, s, max_iters)),
                       ("now", lambda c, b, s: search_mod._run_hops(c, b, s, max_iters,
                                                                    False))):
        calls = {"cond": 0, "body": 0}
        cond, body, state = _toy_loop(limits, calls)
        tracing.enable()
        try:
            out = loop(cond, body, state)
        finally:
            tracing.disable()
        snap = tracing.snapshot()
        tracing.reset()
        syncs = sum(r.name == "search.hop.sync" for r in snap["records"])
        runs[name] = (out, calls, snap["counters"].get("search.hops", 0), syncs)
    (out0, calls0, hops0, _), (out1, calls1, hops1, syncs1) = runs["before"], runs["now"]
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))
    assert calls1 == calls0 and hops1 == hops0
    assert syncs1 == (0 if max_iters == 0 else min(hops0 + 1, max_iters))
    want = torch.clamp(torch.as_tensor(limits), max=max_iters)
    assert torch.equal(out1[0], torch.where(torch.as_tensor(limits) > 0, want, 0))


def _spy_n_exact(monkeypatch):
    """Keep each gated query's n_exact, which StoredSearcher.search drops."""
    got = []
    real = search_mod.batched_sketch_gated_query

    def spy(*a, **kw):
        out = real(*a, **kw)
        got.append(out[2].clone())
        return out

    monkeypatch.setattr(search_mod, "batched_sketch_gated_query", spy)
    return got


GATED = {
    "p16-fused": dict(gate="sketch", ef=32, promote_width=16, max_iters=12, expand_width=2,
                      final_rescore=64, hop_merge="fused"),
    "p16-inline-fr0": dict(gate="sketch", ef=32, promote_width=16, max_iters=12,
                           expand_width=2, hop_merge="inline"),
    "long": dict(gate="sketch", ef=16, promote_width=8, max_iters=200, hop_merge="fused"),
    "one-hop": dict(gate="sketch", ef=32, promote_width=8, max_iters=1, final_rescore=16),
}


@pytest.mark.parametrize("knobs", list(GATED))
def test_gated_query_keeps_the_loop_before_it(setups, knobs, monkeypatch):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"])
    got = _spy_n_exact(monkeypatch)
    now = s["port"].search(q, k=10, **GATED[knobs])
    loop = search_mod._run_hops
    monkeypatch.setattr(search_mod, "_run_hops",
                        lambda c, b, st, mi, static, hops=None:
                        loop(c, b, st, mi, static) if static else _loop_before(c, b, st, mi))
    before = s["port"].search(q, k=10, **GATED[knobs])
    assert torch.equal(now[0], before[0]) and torch.equal(now[1], before[1])
    assert torch.equal(got[0], got[1])


def _graphed(port, monkeypatch, capture=None):
    cache = GraphCache(capture or EagerCapture(), search_mod.HOP_GRAPHS_KEPT)
    monkeypatch.setattr(port, "_hop_graphs", cache)
    return cache


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("knobs", list(GATED))
def test_graph_route_answers_as_the_eager_route(setups, knobs, b, monkeypatch):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"][:b])
    got = _spy_n_exact(monkeypatch)
    eager = s["port"].search(q, k=10, **GATED[knobs])
    cache = _graphed(s["port"], monkeypatch)
    tracing.enable()
    try:
        graphed = s["port"].search(q, k=10, **GATED[knobs])
    finally:
        tracing.disable()
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    assert torch.equal(got[0], got[1])
    counters = tracing.snapshot()["counters"]
    assert counters["search.hop.graphed"] == counters["search.hops"] > 0
    assert len(cache._graphs) == 1


def test_graph_cache_keys_by_shape_and_keeps_the_latest(setups, monkeypatch):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"])
    capture = EagerCapture()
    monkeypatch.setattr(search_mod, "HOP_GRAPHS_KEPT", 2)
    cache = _graphed(s["port"], monkeypatch, capture)
    kw = dict(gate="sketch", ef=32, promote_width=16, max_iters=4, expand_width=2)
    s["port"].search(q[:8], k=10, **kw)
    s["port"].search(q[8:16], k=10, **kw)  # same shape: the entry is reused
    assert capture.captures == 1
    assert list(cache._graphs) == [(8, 32, 64, 16, 2, "inline")]
    s["port"].search(q[:4], k=10, **kw)  # another batch
    s["port"].search(q[:8], k=10, **kw)  # touched: now the latest
    s["port"].search(q[:8], k=10, **dict(kw, hop_merge="fused", aq_width=96))
    assert capture.captures == 3
    assert list(cache._graphs) == [(8, 32, 64, 16, 2, "inline"), (8, 32, 96, 16, 2, "fused")]
    # max_iters, k and final_rescore are no part of the hop: no new capture
    s["port"].search(q[:8], k=5, **dict(kw, max_iters=9, final_rescore=32))
    # the static loop and the exact gate never take the graph
    s["port"].search(q[:8], k=10, **dict(kw, static_loop=True))
    s["port"].search(q[:8], k=10, gate="exact", ef=32)
    assert capture.captures == 3


def test_graph_route_returns_no_view_of_its_buffers(setups, monkeypatch):
    s = setups("euclidean")
    q = torch.from_numpy(s["q"])
    _graphed(s["port"], monkeypatch)
    kw = dict(gate="sketch", ef=32, promote_width=16, max_iters=12, expand_width=2)
    d1, i1 = s["port"].search(q[:16], k=32, **kw)  # k = ef, final_rescore 0
    keep = d1.clone(), i1.clone()
    s["port"].search(q[16:32], k=32, **kw)
    assert torch.equal(d1, keep[0]) and torch.equal(i1, keep[1])


def test_graph_capture_error_raises_and_counts_nothing(setups, monkeypatch):
    s = setups("euclidean")

    def broken(run, device):
        run()
        raise RuntimeError("capture failed")

    _graphed(s["port"], monkeypatch, broken)
    before = search_mod.hop_merge.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        s["port"].search(torch.from_numpy(s["q"][:4]), k=10, gate="sketch", ef=32)
    assert search_mod.hop_merge.launches == before


def test_graph_route_under_concurrent_calls(setups, monkeypatch):
    # More threads than cores on one searcher and one shape: each call holds
    # its entry from binding its queries to cloning its answers out.
    import os
    import sys

    s = setups("euclidean")
    q = torch.from_numpy(s["q"])
    kw = dict(gate="sketch", ef=32, promote_width=16, max_iters=12, expand_width=2,
              final_rescore=64)
    parts = [q[i:i + 4] for i in range(0, 64, 4)]
    want = [s["port"].search(p, k=10, **kw) for p in parts]
    _graphed(s["port"], monkeypatch)
    results: dict = {}

    def work(t):
        for r in range(3):
            j = (t + r) % len(parts)
            results[(t, r)] = (j, s["port"].search(parts[j], k=10, **kw))

    n = max(8, 2 * (os.cpu_count() or 1))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 3 * n
    for j, (d, ids) in results.values():
        assert torch.equal(d, want[j][0]) and torch.equal(ids, want[j][1])
