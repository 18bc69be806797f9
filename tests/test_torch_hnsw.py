"""HnswIndex and the search API of the PyTorch port against the JAX package
(tests/test_hnsw.py mirrored).

- On an index the reference built and the port carried across
  (convert.hnsw_from_numpy: layer 0, the upper layers and the stored
  vectors), the port's search returns the reference's ids on every row, with
  distances within 1e-6, and the port's Searcher the reference Searcher's
  hits.
- The port's own build (its own projection draw, so another graph) reaches
  recall@10 within 0.01 of the reference's, over the same numpy queries, and
  the reference test's floors.
- save_hnsw / load_hnsw: a file written by either package loads in the
  other and searches identically."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu.core import storage as jst
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import HnswConfig as JHnswConfig
from islands_tpu.core.config import SearchConfig as JSearchConfig
from islands_tpu.core.hnsw import HnswIndex as JHnsw
from islands_tpu.core.searchapi import Searcher as JSearcher
from islands_tpu.ops import distance as jd
from islands_tpu_torch.convert import hnsw_from_numpy
from islands_tpu_torch.core import storage as tst
from islands_tpu_torch.core.config import ConfigError, DistanceMetric, HnswConfig, SearchConfig
from islands_tpu_torch.core.hnsw import HnswIndex, _greedy_descend
from islands_tpu_torch.core.searchapi import MultiIndexSearcher, Searcher, SearchResult

from conftest import make_vectors

N, DIM = 600, 32
FAST = dict(m=8, m0=16, ef_construction=64, wave_size=128, intra_wave_k=8, reverse_slack=8)


def _recall(ids, tids):
    ids = ids.numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / tids.shape[1]
                          for a, b in zip(ids, tids)]))


def _carry(ref, cfg=None):
    g = ref.layer0
    return hnsw_from_numpy(
        cfg or HnswConfig(**FAST), np.asarray(ref.x), ref.levels,
        layer0=dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                    levels=ref.levels, entry_point=ref.entry_point, max_level=ref.max_level),
        layers=[(l.ids, np.asarray(l.neighbors)) for l in ref.layers], device="cpu")


@pytest.fixture(scope="module")
def state():
    corpus = make_vectors(N, DIM, seed=17)
    ref = JHnsw(JHnswConfig(**FAST)).build(corpus)
    port = HnswIndex(HnswConfig(**FAST), device="cpu").build(corpus)
    q = make_vectors(64, DIM, seed=55)
    _, tids = jd.brute_force_topk(jnp.asarray(q), jnp.asarray(corpus), 10)
    return dict(corpus=corpus, ref=ref, port=port, carried=_carry(ref), q=q,
                tq=torch.from_numpy(q), tids=np.asarray(tids))


@pytest.mark.parametrize("ef", [16, 64, 100])
def test_carried_index_returns_reference_ids(state, ef):
    jd_, ji = state["ref"].search(state["q"], k=10, ef=ef)
    td_, ti = state["carried"].search(state["tq"], k=10, ef=ef)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=0, atol=1e-6)


def test_greedy_descend_matches_reference(state):
    from islands_tpu.core.hnsw import _greedy_descend as j_descend

    ref, carried = state["ref"], state["carried"]
    top = ref.layers[0]
    qp = jd.prep_query(jnp.asarray(state["q"]), ref.config.metric)
    start = np.zeros(len(state["q"]), np.int32)
    want = j_descend(qp, top.neighbors, top.x_local, jnp.asarray(start), ref.config.metric)
    got = _greedy_descend(torch.from_numpy(np.array(qp)), carried.layers[0].neighbors,
                          carried.layers[0].x_local, torch.from_numpy(start),
                          carried.config.metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_own_build_recall_near_reference(state):
    r_ref = _recall(state["ref"].search(state["q"], k=10, ef=100)[1], state["tids"])
    r_port = _recall(state["port"].search(state["tq"], k=10, ef=100)[1], state["tids"])
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert r_port >= 0.9


def test_layers_structure(state):
    built, ref = state["port"], state["ref"]
    assert built.num_nodes == N and built.max_level == len(built.layers)
    np.testing.assert_array_equal(built.levels, ref.levels)  # numpy draw: equal
    sizes = [len(l.ids) for l in built.layers]
    assert sizes == [len(l.ids) for l in ref.layers]
    assert all(a > b for a, b in zip([N] + sizes, sizes))
    assert built.levels[built.entry_point] == built.max_level
    assert built.entry_point == ref.entry_point


def test_presets_and_validation():
    for p in ("fast", "accurate"):
        assert dataclasses.asdict(getattr(HnswConfig, p)()) == dataclasses.asdict(
            getattr(JHnswConfig, p)())
    assert [(f.name, f.default) for f in dataclasses.fields(HnswConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JHnswConfig)]
    for layer in (0, 1, 3):
        assert dataclasses.asdict(HnswConfig(**FAST).to_leann(layer)) == dataclasses.asdict(
            JHnswConfig(**FAST).to_leann(layer))
    for bad in (dict(m=0), dict(m=16, m0=8), dict(ef_construction=4), dict(max_layers=0)):
        with pytest.raises(ConfigError):
            HnswConfig(**bad).validate()
    assert [(f.name, f.default) for f in dataclasses.fields(SearchConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JSearchConfig)]


def test_empty_single_and_determinism(state):
    idx = HnswIndex(HnswConfig(**FAST), device="cpu").build(np.zeros((0, 8), np.float32))
    assert idx.is_empty
    d, _ = idx.search(np.zeros((3, 8), np.float32), k=5)
    assert d.shape == (3, 0)
    d, i = state["port"].search(state["q"][0], k=5)
    assert d.shape == (5,) and i.shape == (5,) and bool((d[1:] >= d[:-1]).all())
    a = state["port"].search(state["tq"][:8], k=10)[1]
    assert torch.equal(a, state["port"].search(state["tq"][:8], k=10)[1])


def test_extend_matches_reference_recall(state):
    corpus = state["corpus"]
    ref = JHnsw(JHnswConfig(**FAST)).build(corpus[:400])
    port = _carry(ref)
    ref.extend(corpus[400:])
    port.extend(corpus[400:])
    assert port.num_nodes == N
    np.testing.assert_array_equal(port.levels, ref.levels)
    r_ref = _recall(ref.search(state["q"], k=10, ef=100)[1], state["tids"])
    _, ids = port.search(state["tq"], k=10, ef=100)
    r_port = _recall(ids, state["tids"])
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert r_port >= 0.85 and bool((ids >= 400).any())
    assert HnswIndex(HnswConfig(**FAST), device="cpu").extend(corpus[:100]).num_nodes == 100


def test_euclidean_metric(state):
    cfg = dict(FAST, metric=DistanceMetric.EUCLIDEAN)
    idx = HnswIndex(HnswConfig(**cfg), device="cpu").build(state["corpus"])
    _, tids = jd.brute_force_topk(jnp.asarray(state["q"]), jnp.asarray(state["corpus"]), 10,
                                  JM.EUCLIDEAN)
    assert _recall(idx.search(state["tq"], k=10, ef=100)[1], np.asarray(tids)) >= 0.85


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_hnsw_files_cross_load(state, tmp_path, writer):
    ref, carried = state["ref"], state["carried"]
    path = tmp_path / "index.hnsw"
    if writer == "reference":
        nbytes = jst.save_hnsw(ref, path)
        loaded = tst.load_hnsw(path, device="cpu")
        assert loaded.config == carried.config
        d2, i2 = loaded.search(state["tq"], k=10, ef=64)
        d1, i1 = carried.search(state["tq"], k=10, ef=64)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)
    else:
        nbytes = tst.save_hnsw(carried, path)
        loaded = jst.load_hnsw(path)
        assert loaded.config == ref.config
        d1, i1 = ref.search(state["q"], k=10, ef=64)
        d2, i2 = loaded.search(state["q"], k=10, ef=64)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    assert path.stat().st_size == nbytes
    assert (loaded.num_nodes, loaded.entry_point, len(loaded.layers)) == (
        N, ref.entry_point, len(ref.layers))


def test_hnsw_round_trip_and_unbuilt_save(state, tmp_path):
    port = state["port"]
    tst.save_hnsw(port, tmp_path / "own.hnsw")
    loaded = tst.load_hnsw(tmp_path / "own.hnsw", device="cpu")
    a, b = port.search(state["tq"], k=5, ef=64), loaded.search(state["tq"], k=5, ef=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(tst.StorageError):
        tst.save_hnsw(HnswIndex(device="cpu"), tmp_path / "x.hnsw")


# -- the search API ------------------------------------------------------------


def test_searcher_matches_reference(state):
    want = JSearcher(state["ref"], JSearchConfig(top_k=10, ef=64)).search(state["q"])
    got = Searcher(state["carried"], SearchConfig(top_k=10, ef=64)).search(state["tq"])
    assert [[h.id for h in hits] for hits in got] == [[h.id for h in hits] for hits in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h.distance for h in g], [h.distance for h in w],
                                   rtol=0, atol=1e-6)


def test_similarity_mapping():
    assert SearchResult(id=1, distance=0.0).similarity == 1.0
    assert SearchResult(id=1, distance=1.0).similarity == 0.5


def test_searcher_chained_settings(state):
    s = Searcher(state["port"]).with_top_k(5).with_ef(64).with_vectors()
    out = s.search(make_vectors(4, DIM, seed=41))
    assert len(out) == 4
    for hits in out:
        assert len(hits) <= 5
        assert all(isinstance(h.vector, np.ndarray) and h.vector.shape == (DIM,) for h in hits)
        sims = [h.similarity for h in hits]
        assert sims == sorted(sims, reverse=True)


def test_searcher_operating_point_knobs():
    from islands_tpu_torch.core.build import build_index_with_sketch
    from islands_tpu_torch.core.config import LeannConfig
    from islands_tpu_torch.core.search import StoredSearcher

    metric = DistanceMetric.EUCLIDEAN
    x = make_vectors(400, 32, seed=71)
    cfg = LeannConfig(metric=metric, m=8, m0=16, reverse_slack=16, wave_size=128,
                      ef_construction=32, sketch_dims=16)
    graph, sk = build_index_with_sketch(x, cfg, device="cpu")
    idx = StoredSearcher(graph, x, metric, sketch=sk, device="cpu")
    out = (Searcher(idx).with_top_k(5).with_ef(32).with_promote_width(16).with_max_iters(8)
           .search(make_vectors(4, 32, seed=72)))
    assert len(out) == 4 and all(len(h) <= 5 for h in out)
    with pytest.raises(ConfigError):
        Searcher(idx).with_max_iters(0)
    with pytest.raises(ConfigError):
        Searcher(idx).with_promote_width(-1)


def test_min_similarity_filter_and_single_query(state):
    q = make_vectors(4, DIM, seed=41)
    all_hits = Searcher(state["port"]).with_top_k(10).search(q)
    filt = Searcher(state["port"]).with_top_k(10).with_min_similarity(0.99).search(q)
    for a, f in zip(all_hits, filt):
        assert len(f) <= len(a) and all(h.similarity >= 0.99 for h in f)
    out = Searcher(state["port"]).search(make_vectors(1, DIM, seed=2)[0])
    assert len(out) == 1 and isinstance(out[0], list)


def test_multi_index_merge(state):
    corpus = state["corpus"]
    a = HnswIndex(HnswConfig(**FAST), device="cpu").build(corpus[:300])
    b = HnswIndex(HnswConfig(**FAST), device="cpu").build(corpus[300:])
    ms = MultiIndexSearcher(SearchConfig(top_k=10, ef=64)).add_index("a", a).add_index("b", b)
    q = make_vectors(4, DIM, seed=67)
    out = ms.search(q)
    assert len(out) == 4
    for hits in out:
        assert len(hits) <= 10 and {h.index_name for h in hits} <= {"a", "b"}
        sims = [h.similarity for h in hits]
        assert sims == sorted(sims, reverse=True)
    assert all(h.index_name == "a" for hits in ms.search(q, index_names=["a"]) for h in hits)
    ms.remove_index("b")
    assert "b" not in ms.indexes
