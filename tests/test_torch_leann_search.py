"""LeannIndex.search (the recompute gate with pruning) and LeannIndex.extend
of the PyTorch port against the JAX package.

The reference builds the index; the port's is assembled from its arrays
(convert.leann_from_numpy), so both search one structure, on the same numpy
queries. Tolerances:
- gate "none" without pruning, with GLOBAL and with LOCAL pruning, and the
  sketch gate: the reference's ids on every row, distances within 1e-6 (the
  scorers' float32 sums run in other orders), and for the sketch gate the
  same last_recompute_fraction. Those strategies are deterministic.
- PROPORTIONAL draws its accept mask from jax.random, which torch cannot
  reproduce; the port draws from a counter-based hash of (seed, hop,
  query salt), so it is held by recall@10 within 0.02 of the reference's.
- extend and build.extend_graph, from the reference's 600-node prefix to all
  800 items: recall@10 within 0.01 of the reference's extended index, both
  searched by the same searcher (tests/test_leann.py's extend test, whose
  floor 0.9 and reachability checks apply too)."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu.core import build as jbuild
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.config import PruningStrategy as JP
from islands_tpu.core.embedding import InMemoryEmbeddingProvider as JProvider
from islands_tpu.core.leann import LeannIndex as JIndex
from islands_tpu.ops import distance as jd
from islands_tpu_torch.convert import graph_from_numpy, leann_from_numpy
from islands_tpu_torch.core import build as tbuild
from islands_tpu_torch.core import search as search_mod
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.config import PQConfig as TPQConfig
from islands_tpu_torch.core.config import PruningStrategy as TP
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.search import HOP_GRAPHS_KEPT, StoredSearcher, make_prune_fn
from islands_tpu_torch.ops import distance as td
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.utils import tracing
from islands_tpu_torch.utils.graphs import GraphCache

from conftest import make_vectors
from torch_graph_capture import EagerCapture

N, DIM, N_PREFIX = 800, 48, 600
SMALL = dict(m=12, m0=24, ef_construction=64, wave_size=128, intra_wave_k=8, reverse_slack=12)
PRUNED = {"none": None, "global": "global", "local": "local"}


def _graph_args(g):
    return dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                levels=np.asarray(g.levels), entry_point=int(g.entry_point),
                max_level=int(g.max_level))


def _sketch_args(s):
    return dict(w=np.asarray(s.w), scale=np.asarray(s.scale),
                node_sketch=np.asarray(s.node_sketch), nbr_sketch=np.asarray(s.nbr_sketch))


def _pair(ref, **cfg):
    """The reference index under config `cfg` (same graph and sketch) and
    the port's index carried across from it."""
    j = JIndex(JConfig(**SMALL, **cfg))
    j.graph, j.sketch, j.dimension = ref.graph, ref.sketch, ref.dimension
    j._init_routing()
    tcfg = {k: (TP(v.value) if isinstance(v, JP) else v) for k, v in cfg.items()}
    t = leann_from_numpy(TConfig(**SMALL, **tcfg), DIM, graph=_graph_args(ref.graph),
                         sketch=_sketch_args(ref.sketch) if ref.sketch is not None else None,
                         device="cpu")
    return j, t


def _recall(ids, tids):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                          for a, b in zip(ids, tids)]))


@pytest.fixture(scope="module")
def state():
    x = make_vectors(N, DIM, seed=11)
    q = make_vectors(64, DIM, seed=99)
    jprov = JProvider(x)
    ref = JIndex(JConfig(**SMALL))
    ref.build(jprov)
    _, tids = jd.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10)
    return dict(x=x, q=q, tq=torch.from_numpy(q), ref=ref, jprov=jprov,
                tprov=InMemoryEmbeddingProvider(x, device="cpu"), tids=np.asarray(tids))


@pytest.mark.parametrize("strategy", list(PRUNED))
def test_recompute_gate_matches_reference_ids(state, strategy):
    cfg = {} if PRUNED[strategy] is None else dict(prune_ratio=0.3,
                                                     pruning_strategy=JP(PRUNED[strategy]))
    j, t = _pair(state["ref"], **cfg)
    jd_, ji = j.search(state["q"], k=10, provider=state["jprov"], ef=64, gate="none")
    td_, ti = t.search(state["tq"], k=10, provider=state["tprov"], ef=64, gate="none")
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td_.numpy(), jd_, rtol=0, atol=1e-6)
    assert _recall(ti.numpy(), state["tids"]) >= (0.9 if strategy == "none" else 0.6)


@pytest.mark.parametrize("kw", [dict(ef=48), dict(ef=32, promote_width=8, max_iters=12)])
def test_sketch_gate_matches_reference_ids(state, kw):
    j, t = _pair(state["ref"])
    jd_, ji = j.search(state["q"], k=10, provider=state["jprov"], gate="sketch", **kw)
    td_, ti = t.search(state["tq"], k=10, provider=state["tprov"], gate="sketch", **kw)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td_.numpy(), jd_, rtol=0, atol=1e-6)
    assert t.last_recompute_fraction == j.last_recompute_fraction


def test_config_defaults_and_auto_gate(state):
    # sketch_query makes "auto" the sketch gate; promote_width and
    # max_search_iters of the config reach it; a single query works.
    cfg = dict(sketch_query=True, promote_width=8, max_search_iters=6)
    j, t = _pair(state["ref"], **cfg)
    _, ji = j.search(state["q"], k=10, provider=state["jprov"], ef=32)
    _, ti = t.search(state["tq"], k=10, provider=state["tprov"], ef=32)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert t.last_recompute_fraction == j.last_recompute_fraction
    d1, i1 = t.search(state["tq"][5], k=4, provider=state["tprov"], ef=32)
    assert d1.shape == (4,) and torch.equal(i1, ti[5, :4])


def test_proportional_pruning_holds_recall(state):
    j, t = _pair(state["ref"], prune_ratio=0.3, pruning_strategy=JP.PROPORTIONAL)
    _, ji = j.search(state["q"], k=10, provider=state["jprov"], ef=64, gate="none")
    _, ti = t.search(state["tq"], k=10, provider=state["tprov"], ef=64, gate="none")
    r_ref, r_port = _recall(np.asarray(ji), state["tids"]), _recall(ti.numpy(), state["tids"])
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
    assert r_port >= 0.6


def test_proportional_draw_is_per_query_and_batch_free():
    # The accept mask of a query depends on (seed, hop, its salt) only: the
    # same query in another batch, or alone, draws the same mask.
    prune = make_prune_fn(TP.PROPORTIONAL, 0.5, ef=32, seed=3)
    rng = np.random.default_rng(0)
    degrees = torch.from_numpy(rng.integers(1, 30, 500).astype(np.int32))
    ids = torch.from_numpy(np.sort(rng.integers(0, 500, (6, 40)), axis=1).astype(np.int32))
    keep = torch.from_numpy(rng.random((6, 40)) < 0.8)
    salt = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 6).astype(np.int32))
    count = torch.full((6,), 10, dtype=torch.int32)
    full = prune(degrees, ids, keep, count, 4, salt)
    rev = prune(degrees, ids.flip(0), keep.flip(0), count, 4, salt.flip(0))
    assert torch.equal(full, rev.flip(0))
    assert torch.equal(full[2:3], prune(degrees, ids[2:3], keep[2:3], count[:1], 4, salt[2:3]))
    assert bool((full <= keep).all()) and bool(full.any(dim=1)[keep.any(dim=1)].all())
    assert not torch.equal(full, prune(degrees, ids, keep, count, 5, salt))


@pytest.fixture(scope="module")
def extended(state):
    x = state["x"]
    ref = JIndex(JConfig(**SMALL))
    ref.build(state["jprov"], num_vectors=N_PREFIX)
    port = leann_from_numpy(TConfig(**SMALL), DIM, graph=_graph_args(ref.graph),
                            sketch=_sketch_args(ref.sketch), device="cpu")
    prefix = (np.array(ref.graph.neighbors), np.array(ref.graph.degrees),
              int(ref.graph.entry_point))
    ref.extend(state["jprov"])
    port.extend(state["tprov"])
    return dict(ref=ref, port=port, prefix=prefix, x=x)


def _stored_recall(graph_args, state):
    g = graph_from_numpy(**graph_args, device="cpu")
    _, ids = StoredSearcher(g, state["x"], device="cpu").search(state["tq"], k=10, ef=96)
    return _recall(ids.numpy(), state["tids"]), ids.numpy()


def test_extend_matches_reference_recall(state, extended):
    ref, port = extended["ref"], extended["port"]
    assert port.num_nodes == ref.num_nodes == N
    port.graph.validate()
    np.testing.assert_array_equal(port.graph.levels.numpy(), np.asarray(ref.graph.levels))
    assert (port.graph.entry_point, port.graph.max_level) == (int(ref.graph.entry_point),
                                                              int(ref.graph.max_level))
    _, ji = ref.search(state["q"], k=10, provider=state["jprov"], ef=96)
    _, ti = port.search(state["tq"], k=10, provider=state["tprov"], ef=96)
    r_ref, r_port = _recall(np.asarray(ji), state["tids"]), _recall(ti.numpy(), state["tids"])
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert r_port >= 0.9 and np.any(ti.numpy() >= N_PREFIX)
    # The sketch keeps its projection and is rederived for all 800 rows.
    assert torch.equal(port.sketch.w, torch.from_numpy(np.array(ref.sketch.w)))
    assert port.sketch.node_sketch.shape == tuple(ref.sketch.node_sketch.shape)


def test_extend_graph_matches_reference_recall(state, extended):
    nbrs, degs, entry = extended["prefix"]
    cfg = JConfig(**SMALL)
    xp = np.asarray(jd.prep_corpus(jnp.asarray(state["x"]), cfg.metric))
    jn, jdeg = jbuild.extend_graph(jnp.asarray(nbrs), jnp.asarray(degs), jnp.asarray(xp),
                                   N_PREFIX, cfg, entry)
    tn, tdeg = tbuild.extend_graph(torch.from_numpy(nbrs), torch.from_numpy(degs),
                                   torch.from_numpy(xp), N_PREFIX, TConfig(**SMALL), entry)
    assert tuple(tn.shape) == tuple(jn.shape) == (N, 24)
    levels = np.zeros(N, np.int32)
    r_ref, _ = _stored_recall(dict(neighbors=np.asarray(jn), degrees=np.asarray(jdeg),
                                   levels=levels, entry_point=entry, max_level=0), state)
    r_port, ids = _stored_recall(dict(neighbors=tn.numpy(), degrees=tdeg.numpy(),
                                      levels=levels, entry_point=entry, max_level=0), state)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert np.any(ids >= N_PREFIX)


def test_extend_noop_and_from_empty(state):
    cfg = TConfig(**SMALL)
    idx = tbuild.build_index(state["x"][:300], cfg, device="cpu")
    from islands_tpu_torch.core.leann import LeannIndex

    leann = LeannIndex(cfg, device="cpu")
    leann.build(state["tprov"], num_vectors=300)
    before = leann.graph.neighbors.clone()
    leann.extend(state["tprov"], num_total=300)  # nothing to append
    assert torch.equal(leann.graph.neighbors, before)
    assert torch.equal(before, idx.neighbors)
    empty = LeannIndex(cfg, device="cpu")
    empty.build(state["tprov"], num_vectors=0)
    empty.extend(state["tprov"], num_total=200)
    assert empty.num_nodes == 200
    assert dataclasses.asdict(empty.config) == dataclasses.asdict(cfg)


# -- the sketch gate's hop replayed as two graphs around the provider ---------
#
# On the CPU `EagerCapture` stands in for CUDA graph capture: each "replay"
# runs the captured step again. The split route must answer as the eager
# route bit for bit and call the provider exactly as often.


class _CountingProvider:
    """A provider that counts its `embed` calls and reads to the host in
    each one, as the packed ModernBERT route reads its rows' lengths."""

    def __init__(self, inner):
        self.inner, self.calls, self.read = inner, 0, 0

    def embed(self, ids):
        self.calls += 1
        self.read += int((ids >= 0).sum())
        return self.inner.embed(ids)


def _traced(fn):
    """fn() with the program's tracing on -> (its result, the counters)."""
    tracing.reset()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return out, counters


def _split_call(idx, q, prov, **kw):
    """One sketch-gated search -> (dists, ids, counters, embed calls)."""
    before = prov.calls
    (d, ids), counters = _traced(lambda: idx.search(q, k=10, provider=prov, gate="sketch",
                                                    **kw))
    return d, ids, counters, prov.calls - before


@pytest.mark.parametrize("kw", [dict(ef=48, promote_width=32, max_iters=36),
                                dict(ef=32, promote_width=8, max_iters=12)],
                         ids=["i36", "narrow"])
@pytest.mark.parametrize("b", [1, 64])
def test_split_hop_graph_answers_as_the_eager_route(state, b, kw):
    _, t = _pair(state["ref"])
    prov = _CountingProvider(state["tprov"])
    capture = EagerCapture()
    graphs = GraphCache(capture, HOP_GRAPHS_KEPT)
    # the call that captures, then one that only replays
    for q in (state["tq"][:b], state["tq"].flip(0)[:b]):
        t._hop_graphs = None
        want = _split_call(t, q, prov, **kw)
        frac = t.last_recompute_fraction
        t._hop_graphs = graphs
        got = _split_call(t, q, prov, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2]["search.exact_rows"] == want[2]["search.exact_rows"]
        assert t.last_recompute_fraction == frac
        hops = want[2]["search.hops"]
        assert got[2]["search.hop.graphed"] == got[2]["search.hops"] == hops > 0
        assert "search.hop.graphed" not in want[2]
        # the provider runs once a hop plus the route's entry scores, on both
        assert got[3] == want[3] == hops + 1
    assert capture.captures == 2  # pre and post, once for the shape
    assert len(graphs._graphs) == 1


def test_split_hop_graph_follows_extend_and_rebuild(state):
    x, q = state["x"], state["tq"][:16]
    capture = EagerCapture()
    idx = LeannIndex(TConfig(**SMALL), device="cpu")
    idx.build(state["tprov"], num_vectors=N_PREFIX)
    graphs = idx._hop_graphs = GraphCache(capture, HOP_GRAPHS_KEPT)
    kw = dict(k=10, gate="sketch", ef=48, promote_width=32)

    def both(idx, prov):
        got = idx.search(q, provider=prov, **kw)
        graphs = idx._hop_graphs
        idx._hop_graphs = None
        want = idx.search(q, provider=prov, **kw)
        idx._hop_graphs = graphs
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return got

    def replaced(graphs):
        """The index holds a new, empty cache with the same capture."""
        new = idx._hop_graphs
        assert new is not graphs and new.capture is capture and len(new._graphs) == 0
        return new

    both(idx, state["tprov"])
    assert capture.captures == 2
    idx.extend(state["tprov"])
    graphs = replaced(graphs)
    _, ids = both(idx, state["tprov"])
    assert capture.captures == 4 and bool((ids >= N_PREFIX).any())
    fresh = LeannIndex(TConfig(**SMALL), device="cpu")
    fresh.build(InMemoryEmbeddingProvider(x[:N_PREFIX], device="cpu"))
    fresh.extend(state["tprov"])
    want = fresh.search(q, provider=state["tprov"], **kw)
    got = idx.search(q, provider=state["tprov"], **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a rebuild at the same n swaps every tensor a hop reads
    other = InMemoryEmbeddingProvider(x[::-1].copy(), device="cpu")
    idx.build(other)
    replaced(graphs)
    both(idx, other)
    assert capture.captures == 6


def test_split_hop_graph_returns_no_view_of_its_buffers(state):
    _, t = _pair(state["ref"])
    t._hop_graphs = GraphCache(EagerCapture(), HOP_GRAPHS_KEPT)
    kw = dict(provider=state["tprov"], gate="sketch", ef=48, promote_width=32)
    d1, i1 = t.search(state["tq"][:16], k=48, **kw)  # k = ef
    keep = d1.clone(), i1.clone()
    t.search(state["tq"][16:32], k=48, **kw)
    assert torch.equal(d1, keep[0]) and torch.equal(i1, keep[1])


def test_split_hop_graph_keeps_no_provider_past_the_call(state):
    _, t = _pair(state["ref"])
    t._hop_graphs = GraphCache(EagerCapture(), HOP_GRAPHS_KEPT)
    prov = _CountingProvider(state["tprov"])
    t.search(state["tq"][:4], k=10, provider=prov, gate="sketch", ef=32)
    assert len(t._hop_graphs._graphs) == 1 and prov.calls > 1
    gone = weakref.ref(prov)
    del prov
    gc.collect()
    assert gone() is None  # the cached graphs hold none of its `embed`


def test_split_hop_graph_capture_error_raises_and_counts_nothing(state):
    _, t = _pair(state["ref"])

    def broken(run, device):
        run()
        raise RuntimeError("capture failed")

    t._hop_graphs = GraphCache(broken, HOP_GRAPHS_KEPT)
    prov = _CountingProvider(state["tprov"])
    before = search_mod.hop_merge.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        _traced(lambda: t.search(state["tq"][:4], k=10, provider=prov, gate="sketch", ef=32))
    counters = tracing.snapshot()["counters"]
    assert not any(k in counters for k in ("search.hops", "search.hop.graphed",
                                           "search.exact_rows"))
    assert search_mod.hop_merge.launches == before
    assert prov.calls == 1  # the route's entry scores, before the capture
    assert len(t._hop_graphs._graphs) == 0


def test_other_recompute_routes_take_no_graph(state):
    capture = EagerCapture()
    idx = LeannIndex(TConfig(**SMALL), device="cpu")
    idx.build(state["tprov"], with_pq=TPQConfig(num_subquantizers=8, num_centroids=16))
    idx._hop_graphs = GraphCache(capture, HOP_GRAPHS_KEPT)
    q = state["tq"][:8]
    (_, counters) = _traced(lambda: (
        idx.search(q, k=10, provider=state["tprov"], gate="none", ef=32),
        idx.search_two_level(q, k=10, provider=state["tprov"], ef=32, max_iters=8)))
    # the static loop of the sketch-gated query, over the same provider
    qp = td.prep_query(q, idx.config.metric)
    qs = proj_ops.sketch_query(qp, idx.sketch.w, idx.sketch.scale)
    search_mod.batched_sketch_gated_query(
        qp, qs, state["tprov"].embed, idx.sketch.scale, idx.graph.neighbors,
        idx.sketch.nbr_sketch, idx.sketch.node_sketch, idx._routing,
        exact_scorer=search_mod.make_recompute_scorer(idx.config.metric),
        metric=idx.config.metric, dim=DIM, ef=32, k=10, aq_width=64, promote_width=16,
        max_iters=6, static_iters=True, hop_graphs=idx._hop_graphs)
    assert capture.captures == 0 and len(idx._hop_graphs._graphs) == 0
    assert "search.hop.graphed" not in counters and counters["search.hops"] > 0
