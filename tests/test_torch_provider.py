"""models/provider.py of the port against the JAX package's, and the slice
as a whole: recompute search through an encoder provider.

Tolerances:
- with_center's centre and embed's rows: within 1e-5 of the reference's
  (float32 tiny encoder);
- the slice: a JAX LeannIndex built over a 1,024-chunk tiny-encoder provider
  is carried across (convert.leann_from_numpy) and searched by both
  packages with gate "none" and gate "sketch": at least 99% of id rows
  equal and recall@10 within 0.01 of the reference's (the encoders agree to
  ~1e-6, so a near-tie may swap a row);
- over an encoder whose encode replays graphs (EagerCapture on the CPU):
  rows, counters and search answers equal to the eager route's bit for bit;
- a ModernBERT provider: within 1e-5 of islands_tpu.models.modernbert.encode,
  where the reference's own provider raises (it always runs the BERT
  forward).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.embedding import materialize_embeddings as jmaterialize
from islands_tpu.core.leann import LeannIndex as JIndex
from islands_tpu.models import modernbert as jmb
from islands_tpu.models.encoder import TextEncoder as JEncoder
from islands_tpu.models.provider import EncoderEmbeddingProvider as JProvider
from islands_tpu.ops import distance as jdist
from islands_tpu_torch.convert import leann_from_numpy
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.embedding import EmbeddingProvider
from islands_tpu_torch.models import EncoderConfig, TextEncoder
from islands_tpu_torch.models import bert as bert_mod
from islands_tpu_torch.models import provider as provider_mod
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider
from islands_tpu_torch.utils import tracing

from torch_graph_capture import EagerCapture

N, L = 1024, 32
SMALL = dict(m=12, m0=24, ef_construction=64, wave_size=128, intra_wave_k=8,
             reverse_slack=12, sketch_query=True)


def token_table(n=N, slen=L, vocab=1024, protos=64, seed=0):
    """Chunks of token ids with cluster structure, as the config-3 corpus
    is drawn: prototypes, 30% noise, lengths in [slen/2, slen]."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, vocab, size=(protos, slen))
    ids = p[rng.integers(0, protos, size=n)].copy()
    noise = rng.random((n, slen)) < 0.3
    ids[noise] = rng.integers(1, vocab, size=int(noise.sum()))
    lens = rng.integers(slen // 2, slen + 1, size=n)
    mask = (np.arange(slen)[None, :] < lens[:, None]).astype(np.int32)
    return (ids * mask).astype(np.int32), mask


@pytest.fixture(scope="module")
def providers():
    ids, mask = token_table()
    j = JProvider(JEncoder.from_preset("tiny-test", seed=0), ids, mask)
    t = EncoderEmbeddingProvider(TextEncoder.from_preset("tiny-test", seed=0, device="cpu"),
                                 ids, mask)
    return j, t, j.with_center(), t.with_center()


def test_protocol_and_shapes(providers):
    _, t, _, tc = providers
    assert isinstance(t, EmbeddingProvider) and isinstance(tc, EmbeddingProvider)
    assert t.num_items == N and t.dimension == 64 and t.device.type == "cpu"
    ids = torch.tensor([[0, 5, 7], [N - 1, 3, 3]], dtype=torch.int32)
    out = tc.embed(ids)
    assert out.shape == (2, 3, 64) and out.dtype == torch.float32
    np.testing.assert_array_equal(out[1, 1].numpy(), out[1, 2].numpy())


def test_with_center_matches_reference(providers):
    j, _, jc, tc = providers
    assert not hasattr(j, "device")
    np.testing.assert_allclose(tc.center.numpy(), np.asarray(jc.center), atol=1e-5, rtol=0)


@pytest.mark.parametrize("centered", [False, True])
def test_embed_matches_reference(providers, centered):
    j, t, jc, tc = providers
    jp, tp = (jc, tc) if centered else (j, t)
    ids = np.array([[0, 17, 300, N - 1], [5, 5, 900, 1]], dtype=np.int32)
    # The reference's batch_fn takes [E] ids (its search vmaps over queries).
    want = np.asarray(jp.batch_fn()(jnp.asarray(ids.reshape(-1)))).reshape(2, 4, -1)
    got = tp.embed(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if not centered:
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tp.compute_embeddings_batch([17, 300]), got[0, 1:3].numpy())
    np.testing.assert_array_equal(tp.compute_embedding(900), got[1, 2].numpy())


def test_out_of_range_ids_clamp(providers):
    _, t, _, _ = providers
    got = t.embed(torch.tensor([-4, N + 10]))
    want = t.embed(torch.tensor([0, N - 1]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_embed_chunks_large_hops(monkeypatch):
    """A hop of more rows than one chunk is encoded chunk by chunk with the
    same result."""
    ids, mask = token_table(n=200)
    enc = TextEncoder.from_preset("tiny-test", device="cpu", config=EncoderConfig(batch_size=4))
    prov = EncoderEmbeddingProvider(enc, ids, mask)
    rows = torch.arange(200).view(20, 10)
    whole = prov.embed(rows)
    calls = []
    real = provider_mod.encode
    monkeypatch.setattr(provider_mod, "encode",
                        lambda m, i, k, n: calls.append(i.shape[0]) or real(m, i, k, n))
    monkeypatch.setattr(provider_mod, "EMBED_CHUNK_BATCHES", 8)
    chunked = prov.embed(rows)
    assert calls == [32] * 6 + [8]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6, rtol=0)


def test_from_texts_tokenizes_once():
    texts = [f"document number {i} about topic {i % 7}" for i in range(40)]
    t_enc = TextEncoder.from_preset("tiny-test", seed=0, device="cpu")
    j_enc = JEncoder.from_preset("tiny-test", seed=0)
    t = EncoderEmbeddingProvider.from_texts(t_enc, texts, pad_to=32)
    j = JProvider.from_texts(j_enc, texts, pad_to=32)
    np.testing.assert_array_equal(t.token_ids.numpy(), np.asarray(j.token_ids))
    np.testing.assert_array_equal(t.token_mask.numpy(), np.asarray(j.token_mask))
    np.testing.assert_allclose(t.compute_embeddings_batch(range(5)), t_enc.embed_texts(texts[:5]),
                               atol=2e-5)


def test_modernbert_provider_runs_its_own_forward():
    ids, mask = token_table(n=64)
    t_enc = TextEncoder.from_preset("modernbert-tiny-test", seed=0, device="cpu")
    t = EncoderEmbeddingProvider(t_enc, ids, mask)
    rows = np.array([0, 9, 63, 31], dtype=np.int32)
    params = jmb.init_params(jmb.ModernBertConfig.tiny_test(), 0)
    want = np.asarray(jmb.encode(params, jnp.asarray(ids[rows]), jnp.asarray(mask[rows]),
                                 jmb.ModernBertConfig.tiny_test()))
    np.testing.assert_allclose(t.embed(torch.from_numpy(rows)).numpy(), want, atol=1e-5, rtol=0)
    centered = t.with_center(sample=64, batch=16)
    assert centered.embed(torch.arange(64)).mean(dim=0).abs().max() < 1e-5
    # The reference's provider runs the BERT forward on ModernBERT weights.
    j = JProvider(JEncoder.from_preset("modernbert-tiny-test", seed=0), ids, mask)
    with pytest.raises(AttributeError, match="layer_norm_eps"):
        j.batch_fn()(jnp.asarray(rows))


@pytest.fixture(scope="module")
def slice_state(providers):
    _, _, jc, tc = providers
    ref = JIndex(JConfig(**SMALL)).build(jc, num_vectors=N)
    g, s = ref.graph, ref.sketch
    port = leann_from_numpy(
        TConfig(**SMALL), ref.dimension,
        graph=dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                   levels=np.asarray(g.levels), entry_point=int(g.entry_point),
                   max_level=int(g.max_level)),
        sketch=dict(w=np.asarray(s.w), scale=np.asarray(s.scale),
                    node_sketch=np.asarray(s.node_sketch), nbr_sketch=np.asarray(s.nbr_sketch)),
        device="cpu")
    emb = np.asarray(jmaterialize(jc, N))
    q = emb[:32]
    _, tids = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(emb), 10, ref.config.metric)
    return dict(ref=ref, port=port, q=q, true_ids=np.asarray(tids), emb=emb)


def _recall(ids, tids):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                          for a, b in zip(ids, tids)]))


def test_materialized_embeddings_match(providers, slice_state):
    _, _, _, tc = providers
    got = tc.embed(torch.arange(N)).numpy()
    np.testing.assert_allclose(got, slice_state["emb"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("gate", ["none", "sketch"])
def test_recompute_search_matches_reference(providers, slice_state, gate):
    _, _, jc, tc = providers
    ref, port, q, tids = (slice_state[k] for k in ("ref", "port", "q", "true_ids"))
    _, jids = ref.search(q, k=10, provider=jc, ef=32, gate=gate)
    d, ids = port.search(q, k=10, provider=tc, ef=32, gate=gate)
    jids, ids = np.asarray(jids), ids.numpy()
    assert np.mean(np.all(jids == ids, axis=1)) >= 0.99
    assert abs(_recall(ids, tids) - _recall(jids, tids)) <= 0.01
    assert _recall(ids, tids) >= 0.9
    assert torch.isfinite(d).all()
    if gate == "sketch":
        assert port.last_recompute_fraction == pytest.approx(ref.last_recompute_fraction)


# -- the provider over a BERT whose encode replays CUDA graphs -----------------
#
# `EagerCapture` stands in for CUDA graph capture on the CPU (see
# tests/test_torch_models.py); the graph route answers as the eager one bit
# for bit.


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


@pytest.fixture(scope="module")
def graphed_providers():
    """Providers over 2,048 64-token rows, plain and centred, sharing one
    tiny encoder; the centre is taken on the eager route."""
    ids, mask = token_table(n=2048, slen=64, seed=4)
    enc = TextEncoder.from_preset("tiny-test", seed=0, device="cpu")
    prov = EncoderEmbeddingProvider(enc, ids, mask)
    return prov, prov.with_center(sample=512, batch=128)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("rows", [1, 32, 2048])
def test_graphed_embed_answers_as_the_eager_route(graphed_providers, monkeypatch, rows,
                                                  centered):
    prov = graphed_providers[int(centered)]
    model = prov.encoder.model
    assert model.encode_graphs is None
    capture = EagerCapture()
    graphs = bert_mod.new_encode_graphs(capture)
    rng = np.random.default_rng(rows)
    # a hop's [B, promote] ids: the shape's first call (eager), the call
    # that captures, then one that replays
    shape = (rows // min(rows, 32), min(rows, 32))
    for i in range(3):
        ids = torch.from_numpy(rng.integers(0, 2048, size=shape))
        want = prov.embed(ids)
        monkeypatch.setattr(model, "encode_graphs", graphs)
        got, counters = _traced(lambda: prov.embed(ids))
        monkeypatch.setattr(model, "encode_graphs", None)
        assert torch.equal(got, want) and got.shape == (*shape, 64)
        assert counters == dict({"provider.rows": rows}, **{"encoder.graphed": 1} if i else {})
    assert capture.captures == 1


def test_graphed_embed_counts_each_chunk(monkeypatch):
    ids, mask = token_table(n=64, slen=64)
    enc = TextEncoder.from_preset("tiny-test", device="cpu", config=EncoderConfig(batch_size=4))
    prov = EncoderEmbeddingProvider(enc, ids, mask)
    monkeypatch.setattr(provider_mod, "EMBED_CHUNK_BATCHES", 8)  # 32 rows a chunk
    rows = torch.arange(40)
    want = prov.embed(rows)
    capture = EagerCapture()
    enc.model.encode_graphs = bert_mod.new_encode_graphs(capture)
    for i in range(3):
        got, counters = _traced(lambda: prov.embed(rows))
        assert torch.equal(got, want)
        assert counters == dict({"provider.rows": 40}, **{"encoder.graphed": 2} if i else {})
    assert capture.captures == 2
    assert list(enc.model.encode_graphs._graphs) == [(32, 64, True), (8, 64, True)]


def test_graphed_rows_and_queries_outlive_the_next_call(graphed_providers, monkeypatch):
    """What a caller keeps (the benchmark's sampled rows and raw query
    embeddings) is not rewritten by a later call of the same shape."""
    plain, centred = graphed_providers
    model = plain.encoder.model
    monkeypatch.setattr(model, "encode_graphs", bert_mod.new_encode_graphs(EagerCapture()))
    plain.embed(torch.arange(64, 96))  # the shape's first call: eager
    for prov in (plain, centred):
        first = prov.embed(torch.arange(32))
        kept = first.clone()
        prov.embed(torch.arange(32, 64))
        assert torch.equal(first, kept)
    plain.encoder.encode_tokens(plain.token_ids[8:12], plain.token_mask[8:12])
    q1 = plain.encoder.encode_tokens(plain.token_ids[:4], plain.token_mask[:4])
    kept = q1.clone()
    q2 = plain.encoder.encode_tokens(plain.token_ids[4:8], plain.token_mask[4:8])
    assert torch.equal(q1, kept) and not torch.equal(q1, q2)


def test_recompute_search_with_encoder_graphs_answers_as_eager(providers, slice_state,
                                                               monkeypatch):
    _, _, _, tc = providers
    port, q = slice_state["port"], slice_state["q"]
    kw = dict(k=10, provider=tc, gate="sketch", ef=48, promote_width=32, max_iters=36)
    want = port.search(q, **kw)
    monkeypatch.setattr(tc.encoder.model, "encode_graphs",
                        bert_mod.new_encode_graphs(EagerCapture()))
    for first in (True, False):
        got, counters = _traced(lambda: port.search(q, **kw))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # every embed (one a hop, one for the route's entries) replays one
        # graph, but for each shape's first call
        hops = counters["search.hops"]
        assert counters["encoder.graphed"] == (hops - 1 if first else hops + 1)
    assert counters["provider.rows"] == 32 * (counters["search.hops"] * 32 + 1)
