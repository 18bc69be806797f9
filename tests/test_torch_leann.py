"""LeannIndex of the PyTorch port (config 4's path) against the JAX package.

The reference builds the index (graph, sketch, PQ codebook and codes); the
port's index is assembled from that state (islands_tpu_torch.convert.
leann_from_numpy), so both search the same structure. The corpus is a
seeded Gaussian mixture at a scaled config-4 shape: 3000 x 64 (16
subquantizers x 256 centroids), 256 queries. Tolerances, for
search_two_level on a scaled config-4 ladder, with end rerank, the static
loop and no routing, and for search_pq_scan:
- ids identical on >= 98% of query rows (an f32 near-tie between XLA's and
  torch's summation orders may flip one promotion),
- distances within 1e-5 on the rows whose ids agree,
- recall@10 within 0.005, and last_recompute_fraction equal.
The port's grouped/einsum and fused/inline pairs must be bit-identical, and
the port's own build (its own k-means++ draw and projection) must reach a
recall@10 within 0.01 of the JAX-built index's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.config import PQConfig as JPQConfig
from islands_tpu.core.embedding import InMemoryEmbeddingProvider as JProvider
from islands_tpu.core.leann import LeannIndex as JIndex
from islands_tpu.ops import distance as jd
from islands_tpu_torch.convert import leann_from_numpy
from islands_tpu_torch.core import embedding as temb
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.config import PQConfig as TPQConfig
from islands_tpu_torch.core.leann import DimensionMismatch, IndexNotBuilt, LeannIndex

N, DIM, NQ = 3000, 64, 256
SMALL = dict(m=8, m0=16, ef_construction=48, wave_size=256, intra_wave_k=8, reverse_slack=16)
PQ = dict(num_subquantizers=16, num_centroids=256, training_iterations=8, seed=0)
# bench_extra.py's config-4 ladder scaled to the corpus: ef 128 -> 32,
# routing 65536 -> 256, promote 16/24 -> 8/12, final_rescore 64 -> 32.
ROUTED = dict(ef=32, rerank_ratio=0.25, routing_size=256, expand_width=2)
CASES = {
    "i16/p8/fr32": dict(ROUTED, max_iters=16, promote_width=8, final_rescore=32),
    "i14/p12/fr32": dict(ROUTED, max_iters=14, promote_width=12, final_rescore=32),
    "i18/p8/fr32": dict(ROUTED, max_iters=18, promote_width=8, final_rescore=32),
    "i20/pNone": dict(ROUTED, max_iters=20),
    "end-rerank": dict(ef=32, end_rerank=True, expand_width=2),
    "static-loop": dict(ef=32, static_loop=True, max_iters=10, expand_width=2, promote_width=8),
    "no-routing": dict(ef=32, expand_width=2, promote_width=8),
}


def _mixture():
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((64, DIM)).astype(np.float32)
    x = centres[rng.integers(0, 64, N)] + 1.6 * rng.standard_normal((N, DIM))
    q = centres[rng.integers(0, 64, NQ)] + 1.6 * rng.standard_normal((NQ, DIM))
    return x.astype(np.float32), q.astype(np.float32)


def _recall(ids, tids):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(ids, tids)])


@pytest.fixture(scope="module")
def state():
    x, q = _mixture()
    ref = JIndex(JConfig(metric=JM.EUCLIDEAN, **SMALL))
    ref.build_from_embeddings(x, with_pq=JPQConfig(**PQ))
    g, s = ref.graph, ref.sketch
    port = leann_from_numpy(
        TConfig(metric=TM.EUCLIDEAN, **SMALL), DIM,
        graph=dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                   levels=np.asarray(g.levels), entry_point=int(g.entry_point),
                   max_level=int(g.max_level)),
        pq=dict(centroids=np.asarray(ref.pq.codebook.centroids),
                codes=np.asarray(ref.pq_codes), pq_config=TPQConfig(**PQ)),
        sketch=dict(w=np.asarray(s.w), scale=np.asarray(s.scale),
                    node_sketch=np.asarray(s.node_sketch), nbr_sketch=np.asarray(s.nbr_sketch)),
        device="cpu")
    _, tids = jd.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10, JM.EUCLIDEAN)
    return dict(x=x, q=q, tq=torch.from_numpy(q), tids=np.asarray(tids), ref=ref, port=port,
                jprov=JProvider(x), tprov=temb.InMemoryEmbeddingProvider(x, device="cpu"))


def _assert_parity(got, want, tids):
    (td, ti), (jd_, ji) = got, want
    td, ti = td.numpy(), ti.numpy()
    same = np.all(ti == ji, axis=1)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(td[same], jd_[same], rtol=0, atol=1e-5)
    assert abs(_recall(ti, tids) - _recall(ji, tids)) <= 0.005


@pytest.mark.parametrize("case", list(CASES))
def test_search_two_level_matches_reference(state, case):
    kw = CASES[case]
    want = state["ref"].search_two_level(state["q"], k=10, provider=state["jprov"],
                                         hop_merge="fused", **kw)
    want = tuple(np.asarray(a) for a in want)
    got = state["port"].search_two_level(state["tq"], k=10, provider=state["tprov"],
                                         hop_merge="fused", **kw)
    _assert_parity(got, want, state["tids"])
    assert state["port"].last_recompute_fraction == state["ref"].last_recompute_fraction


@pytest.mark.parametrize("rerank", [32, 64, N])
def test_search_pq_scan_matches_reference(state, rerank):
    want = state["ref"].search_pq_scan(state["q"], k=10, provider=state["jprov"],
                                       rerank=rerank)
    got = state["port"].search_pq_scan(state["tq"], k=10, provider=state["tprov"],
                                       rerank=rerank)
    _assert_parity(got, want, state["tids"])
    assert state["port"].last_recompute_fraction == state["ref"].last_recompute_fraction


@pytest.mark.parametrize("case", ["i16/p8/fr32", "i20/pNone", "end-rerank", "static-loop"])
def test_grouped_einsum_and_fused_inline_are_bit_identical(state, case):
    run = lambda **kw: state["port"].search_two_level(  # noqa: E731
        state["tq"][:64], k=10, provider=state["tprov"], **CASES[case], **kw)
    base = run(adc_impl="grouped", hop_merge="fused")
    for other in (run(adc_impl="einsum", hop_merge="fused"),
                  run(adc_impl="grouped", hop_merge="inline")):
        assert torch.equal(base[0], other[0]) and torch.equal(base[1], other[1])


def test_own_build_recall_near_reference(state):
    own = LeannIndex(TConfig(metric=TM.EUCLIDEAN, **SMALL), device="cpu")
    own.build_from_embeddings(state["x"], with_pq=TPQConfig(**PQ))
    kw = CASES["i16/p8/fr32"]
    _, ids = own.search_two_level(state["tq"], k=10, provider=state["tprov"], **kw)
    _, jids = state["ref"].search_two_level(state["q"], k=10, provider=state["jprov"], **kw)
    r_own, r_ref = _recall(ids.numpy(), state["tids"]), _recall(np.asarray(jids), state["tids"])
    assert abs(r_own - r_ref) <= 0.01, (r_own, r_ref)
    assert own.storage_bytes() == state["ref"].storage_bytes()
    assert own.pq_codes.dtype == torch.uint8 and own.pq_codes.shape == (N, 16)


def test_build_through_a_provider_equals_build_from_embeddings(state):
    x = state["x"][:600]
    cfg = TConfig(metric=TM.EUCLIDEAN, **SMALL)
    pq = TPQConfig(num_subquantizers=8, num_centroids=32, training_iterations=3, seed=0)
    a = LeannIndex(cfg, device="cpu").build(temb.InMemoryEmbeddingProvider(x, device="cpu"),
                                            with_pq=pq)
    b = LeannIndex(cfg, device="cpu").build_from_embeddings(x, with_pq=pq)
    assert torch.equal(a.graph.neighbors, b.graph.neighbors)
    assert torch.equal(a.pq_codes, b.pq_codes)
    assert a.dimension == b.dimension == DIM


def test_single_query_and_storage(state):
    d, ids = state["port"].search_two_level(state["tq"][3], k=5, provider=state["tprov"],
                                            **CASES["no-routing"])
    assert d.shape == (5,) and ids.shape == (5,)
    d, ids = state["port"].search_pq_scan(state["q"][3], k=5, provider=state["tprov"])
    assert d.shape == (5,) and ids.shape == (5,)
    assert state["port"].storage_bytes() == state["ref"].storage_bytes()


def test_errors_raise_where_the_reference_raises(state):
    tprov, q = state["tprov"], state["tq"][:2]
    empty = LeannIndex(TConfig(**SMALL), device="cpu")
    with pytest.raises(IndexNotBuilt):
        empty.search_two_level(q, k=3, provider=tprov)
    with pytest.raises(IndexNotBuilt):
        empty.search_pq_scan(q, k=3, provider=tprov)
    no_pq = LeannIndex(TConfig(metric=TM.EUCLIDEAN, **SMALL), device="cpu")
    no_pq.build_from_embeddings(state["x"][:400])
    with pytest.raises(IndexNotBuilt):
        no_pq.search_two_level(q, k=3, provider=tprov)
    with pytest.raises(IndexNotBuilt):
        no_pq.search_pq_scan(q, k=3, provider=tprov)
    wide = torch.zeros((1, DIM + 1))
    with pytest.raises(DimensionMismatch):
        state["port"].search_two_level(wide, k=3, provider=tprov)
    with pytest.raises(DimensionMismatch):
        state["port"].search_pq_scan(wide, k=3, provider=tprov)
    with pytest.raises(ValueError):
        state["port"].search_two_level(q, k=3, provider=tprov, adc_impl="nope")
    with pytest.raises(ValueError):
        state["port"].search_two_level(q, k=3, provider=tprov, hop_merge="nope")
    with pytest.raises(IndexNotBuilt):
        empty.search(q, k=3, provider=tprov)
    with pytest.raises(IndexNotBuilt):
        empty.extend(tprov)
    with pytest.raises(DimensionMismatch):
        state["port"].search(wide, k=3, provider=tprov)
    with pytest.raises(ValueError):
        state["port"].search(q, k=3, provider=tprov, gate="nope")


def test_pq_scan_k_larger_than_corpus_pads():
    corpus = np.random.default_rng(60).standard_normal((6, 16)).astype(np.float32)
    prov = temb.InMemoryEmbeddingProvider(corpus, device="cpu")
    idx = LeannIndex(TConfig(m=2, m0=4, ef_construction=8, wave_size=8, intra_wave_k=2,
                             reverse_slack=4), device="cpu")
    idx.build(prov, with_pq=TPQConfig(num_subquantizers=4, num_centroids=4,
                                      training_iterations=4, seed=0))
    d, ids = idx.search_pq_scan(corpus[:2], k=10, provider=prov)
    assert d.shape == (2, 10) and ids.shape == (2, 10)
    assert torch.all(ids[:, 6:] == -1) and torch.all(torch.isinf(d[:, 6:]))
    assert torch.equal(ids[:, 0], torch.tensor([0, 1], dtype=torch.int32))


def test_empty_build():
    idx = LeannIndex(TConfig(**SMALL), device="cpu")
    idx.build(temb.InMemoryEmbeddingProvider(np.zeros((0, 8), np.float32), device="cpu"))
    assert idx.is_empty and idx.num_nodes == 0 and idx.dimension == 8


def test_providers_match_reference(state):
    x, jprov, tprov = state["x"], state["jprov"], state["tprov"]
    assert (tprov.dimension, tprov.num_items) == (jprov.dimension, jprov.num_items)
    np.testing.assert_array_equal(tprov.compute_embedding(5), np.asarray(jprov.compute_embedding(5)))
    np.testing.assert_array_equal(tprov.compute_embeddings_batch([1, 3, 5]),
                                  np.asarray(jprov.compute_embeddings_batch([1, 3, 5])))
    ids = torch.tensor([[0, 7, N + 4], [-3, 2, 2]])
    np.testing.assert_array_equal(tprov.embed(ids).numpy(),
                                  x[np.clip(ids.numpy(), 0, N - 1)])
    for bad in ([N], [-1]):
        with pytest.raises(temb.EmbeddingError):
            tprov.compute_embeddings_batch(bad)
    with pytest.raises(temb.EmbeddingError):
        tprov.compute_embedding(N)
    with pytest.raises(temb.EmbeddingError):
        temb.InMemoryEmbeddingProvider(x[0], device="cpu")
    call = temb.CallableEmbeddingProvider(lambda i: torch.from_numpy(x)[i.long()], DIM, N,
                                          device="cpu")
    assert isinstance(call, temb.EmbeddingProvider)
    np.testing.assert_array_equal(call.compute_embedding(9), x[9])
    np.testing.assert_array_equal(temb.materialize_embeddings(call, 2500, batch=1024).numpy(),
                                  x[:2500])
    assert temb.materialize_embeddings(call, 0).shape == (0, DIM)
