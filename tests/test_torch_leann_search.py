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
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.config import PruningStrategy as TP
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.search import StoredSearcher, make_prune_fn
from islands_tpu_torch.ops import distance as td

from conftest import make_vectors

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
