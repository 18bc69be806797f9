"""Storage of the PyTorch port (core/storage.py) against the JAX package.

The file format is the reference's: for the same index every chunk but META
is byte-identical between the two packages (graph, u8 and u16 PQ codes,
sketch), META holds the same keys and values but its timestamps, and a file
written by either package loads in the other and searches identically.
The reference's own storage tests (tests/test_storage.py) are mirrored on
the port. Tolerance: exact (bytes, arrays, search results)."""

import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu.core import storage as jst
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.config import PQConfig as JPQConfig
from islands_tpu.core.embedding import InMemoryEmbeddingProvider as JProvider
from islands_tpu.core.leann import LeannIndex as JIndex
from islands_tpu.core.pq import PQCodebook as JCodebook
from islands_tpu.core.pq import ProductQuantizer as JPQ
from islands_tpu_torch.convert import leann_from_numpy
from islands_tpu_torch.core import storage as tst
from islands_tpu_torch.core.config import LeannConfig, PQConfig
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops import proj as proj_ops

from conftest import make_vectors

SMALL = dict(m=8, m0=16, ef_construction=48, wave_size=64, intra_wave_k=8, reverse_slack=8)
PQ = dict(num_subquantizers=4, num_centroids=32, training_iterations=8, seed=0)


def _carry(ref, pq=None, codes=None):
    g, s = ref.graph, ref.sketch
    pq_cfg = pq or PQConfig(**PQ)
    return leann_from_numpy(
        LeannConfig(**SMALL), ref.dimension,
        graph=dict(neighbors=np.asarray(g.neighbors), degrees=np.asarray(g.degrees),
                   levels=np.asarray(g.levels), entry_point=int(g.entry_point),
                   max_level=int(g.max_level)),
        pq=dict(centroids=np.asarray(ref.pq.codebook.centroids),
                codes=np.asarray(ref.pq_codes) if codes is None else codes, pq_config=pq_cfg),
        sketch=dict(w=np.asarray(s.w), scale=np.asarray(s.scale),
                    node_sketch=np.asarray(s.node_sketch), nbr_sketch=np.asarray(s.nbr_sketch)),
        device="cpu")


@pytest.fixture(scope="module")
def state():
    x = make_vectors(300, 32, seed=4)
    ref = JIndex(JConfig(**SMALL))
    ref.build(JProvider(x), with_pq=JPQConfig(**PQ))
    return dict(x=x, ref=ref, port=_carry(ref), jprov=JProvider(x),
                tprov=InMemoryEmbeddingProvider(x, device="cpu"),
                q=make_vectors(8, 32, seed=77))


def _chunks(path):
    return jst.IndexReader(io.BytesIO(path.read_bytes())).read_all()


def _meta_without_times(data):
    meta = json.loads(data)
    assert meta.pop("created_at") > 0 and meta.pop("updated_at") > 0
    return meta


def test_chunks_are_byte_identical_to_the_reference(state, tmp_path):
    jst.save_index(state["ref"], tmp_path / "j.leann")
    tst.save_index(state["port"], tmp_path / "t.leann")
    j, t = _chunks(tmp_path / "j.leann"), _chunks(tmp_path / "t.leann")
    assert list(j) == list(t) == [b"META", b"GRPH", b"PQCB", b"PQCD", b"SKCH"]
    for tag in (b"GRPH", b"PQCB", b"PQCD", b"SKCH"):
        assert t[tag] == j[tag], tag
    assert list(json.loads(t[b"META"])) == list(json.loads(j[b"META"]))
    assert _meta_without_times(t[b"META"]) == _meta_without_times(j[b"META"])
    cfg = json.loads(t[b"META"])["extra"]["config"]
    assert (cfg["metric"], cfg["pruning_strategy"]) == ("cosine", "global")


def test_u16_codes_are_byte_identical(state, tmp_path):
    # Above 256 centroids the reference keeps uint16 codes, the port int32;
    # both write 2-byte codes.
    ref = state["ref"]
    rng = np.random.default_rng(9)
    centroids = rng.standard_normal((4, 512, 8)).astype(np.float32)
    codes = rng.integers(0, 512, (300, 4)).astype(np.uint16)
    codes[0] = 511
    jref = JIndex(JConfig(**SMALL))
    jref.graph, jref.sketch, jref.dimension = ref.graph, ref.sketch, ref.dimension
    jref.pq = JPQ(JPQConfig(num_subquantizers=4, num_centroids=512))
    jref.pq.codebook = JCodebook(centroids=jnp.asarray(centroids))
    jref.pq_codes = jnp.asarray(codes)
    port = leann_from_numpy(
        LeannConfig(**SMALL), 32, graph=dict(
            neighbors=np.asarray(ref.graph.neighbors), degrees=np.asarray(ref.graph.degrees),
            levels=np.asarray(ref.graph.levels), entry_point=int(ref.graph.entry_point),
            max_level=int(ref.graph.max_level)),
        pq=dict(centroids=centroids, codes=codes,
                pq_config=PQConfig(num_subquantizers=4, num_centroids=512)), device="cpu")
    assert port.pq_codes.dtype == torch.int32
    jst.save_index(jref, tmp_path / "j.leann", persist_sketch=False)
    tst.save_index(port, tmp_path / "t.leann")
    j, t = _chunks(tmp_path / "j.leann"), _chunks(tmp_path / "t.leann")
    assert list(t) == [b"META", b"GRPH", b"PQCB", b"PQCD"]
    for tag in (b"GRPH", b"PQCB", b"PQCD"):
        assert t[tag] == j[tag], tag
    loaded = tst.load_index(tmp_path / "j.leann", device="cpu")
    assert loaded.pq_codes.dtype == torch.int32
    np.testing.assert_array_equal(loaded.pq_codes.numpy(), codes.astype(np.int32))
    back = jst.load_index(tmp_path / "t.leann")
    assert back.pq_codes.dtype == jnp.uint16
    np.testing.assert_array_equal(np.asarray(back.pq_codes), codes)


def test_reference_file_loads_in_the_port(state, tmp_path):
    ref, port = state["ref"], state["port"]
    jst.save_index(ref, tmp_path / "j.leann")
    idx = tst.load_index(tmp_path / "j.leann", device="cpu")
    assert idx.config == port.config and idx.dimension == 32
    for a, b in ((idx.graph.neighbors, port.graph.neighbors),
                 (idx.graph.degrees, port.graph.degrees), (idx.graph.levels, port.graph.levels),
                 (idx.pq_codes, port.pq_codes), (idx.pq.codebook.centroids,
                                                  port.pq.codebook.centroids),
                 (idx.sketch.node_sketch, port.sketch.node_sketch),
                 (idx.sketch.nbr_sketch, port.sketch.nbr_sketch), (idx.sketch.w, port.sketch.w)):
        assert torch.equal(a, b)
    assert float(idx.sketch.scale) == float(port.sketch.scale)
    assert (idx.graph.entry_point, idx.graph.max_level) == (port.graph.entry_point,
                                                            port.graph.max_level)
    q = torch.from_numpy(state["q"])
    for gate in ("none", "sketch"):
        a = idx.search(q, k=5, provider=state["tprov"], ef=48, gate=gate)
        b = port.search(q, k=5, provider=state["tprov"], ef=48, gate=gate)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = idx.search_two_level(q, k=5, provider=state["tprov"], ef=48)
    b = port.search_two_level(q, k=5, provider=state["tprov"], ef=48)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_port_file_loads_in_the_reference(state, tmp_path):
    ref, port = state["ref"], state["port"]
    tst.save_index(port, tmp_path / "t.leann")
    idx = jst.load_index(tmp_path / "t.leann")
    assert idx.config == ref.config and idx.dimension == ref.dimension
    for a, b in ((idx.graph.neighbors, ref.graph.neighbors), (idx.pq_codes, ref.pq_codes),
                 (idx.pq.codebook.centroids, ref.pq.codebook.centroids),
                 (idx.sketch.nbr_sketch, ref.sketch.nbr_sketch), (idx.sketch.w, ref.sketch.w)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d1, i1 = ref.search(state["q"], k=5, provider=state["jprov"], ef=48)
    d2, i2 = idx.search(state["q"], k=5, provider=state["jprov"], ef=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


# -- the reference's own storage tests, on the port ---------------------------


class TestChunkFraming:
    def test_round_trip(self):
        buf = io.BytesIO()
        w = tst.IndexWriter(buf)
        w.write_chunk(b"AAAA", b"hello")
        w.write_chunk(b"BBBB", b"")
        w.write_chunk(b"CCCC", bytes(range(256)))
        buf.seek(0)
        assert tst.IndexReader(buf).read_all() == {
            b"AAAA": b"hello", b"BBBB": b"", b"CCCC": bytes(range(256))}

    def test_metadata_first_chunk(self):
        buf = io.BytesIO()
        tst.IndexWriter(buf).write_metadata(tst.IndexMetadata.new(10, 128, "cosine"))
        buf.seek(0)
        m = tst.IndexReader(buf).read_metadata()
        assert (m.num_vectors, m.dimension, m.metric) == (10, 128, "cosine")

    def test_truncated_payload_raises(self):
        buf = io.BytesIO()
        tst.IndexWriter(buf).write_chunk(b"AAAA", b"hello world")
        with pytest.raises(tst.StorageError):
            tst.IndexReader(io.BytesIO(buf.getvalue()[:-3])).read_all()

    def test_bad_tag_length(self):
        with pytest.raises(tst.StorageError):
            tst.IndexWriter(io.BytesIO()).write_chunk(b"TOOLONG", b"")


class TestPayloadCodecs:
    def test_graph_round_trip(self):
        g = CsrGraph.from_adjacency([[1, 2], [0], [0, 1, 3], [2]], levels=[0, 1, 0, 2],
                                    max_degree=4, device="cpu")
        data = tst.encode_graph(g, "cosine", 16)
        assert data == jst.encode_graph(
            jst.decode_graph(data)[0], "cosine", 16)  # the reference reads it back the same
        g2, metric, dim = tst.decode_graph(data, "cpu")
        assert (metric, dim) == ("cosine", 16)
        assert torch.equal(g2.degrees, g.degrees) and torch.equal(g2.levels, g.levels)
        assert torch.equal(g2.neighbors, g.neighbors)
        assert (g2.entry_point, g2.max_level) == (g.entry_point, g.max_level)

    def test_graph_bytes_per_edge(self):
        adj = [[j for j in range(10) if j != i] for i in range(10)]
        g = CsrGraph.from_adjacency(adj, max_degree=64, device="cpu")
        overhead = tst._GRPH_HEADER.size + 11 * 8 + 10 * 4
        assert len(tst.encode_graph(g, "euclidean", 8)) == overhead + 90 * 4

    def test_codebook_round_trip(self):
        c = np.random.default_rng(0).standard_normal((4, 16, 8)).astype(np.float32)
        assert tst.encode_pq_codebook(c) == jst.encode_pq_codebook(c)
        np.testing.assert_array_equal(tst.decode_pq_codebook(tst.encode_pq_codebook(c)), c)

    def test_codes_round_trip_u8_and_u16(self):
        rng = np.random.default_rng(1)
        for dt, hi, k in ((np.uint8, 255, 256), (np.uint16, 60000, 65536)):
            codes = rng.integers(0, hi, size=(100, 8)).astype(dt)
            data = tst.encode_pq_codes(codes)
            assert data == jst.encode_pq_codes(codes)
            assert tst.encode_pq_codes(codes.astype(np.int32), k) == data
            c2 = tst.decode_pq_codes(data)
            assert c2.dtype == codes.dtype
            np.testing.assert_array_equal(codes, c2)

    @pytest.mark.parametrize("decode", ["graph", "codebook", "codes", "sketch"])
    def test_bad_magic(self, decode):
        bad = b"XXXX" + bytes(100)
        with pytest.raises(tst.StorageError):
            if decode == "graph":
                tst.decode_graph(bad, "cpu")
            elif decode == "codebook":
                tst.decode_pq_codebook(bad)
            elif decode == "codes":
                tst.decode_pq_codes(bad)
            else:
                tst.decode_sketch(bad, torch.zeros((1, 1), dtype=torch.int32))


class TestFileSystemStorage:
    def test_crud(self, tmp_path):
        fs = tst.FileSystemStorage(tmp_path)
        assert not fs.exists("a/b.bin")
        fs.save("a/b.bin", b"data")
        assert fs.exists("a/b.bin") and fs.load("a/b.bin") == b"data"
        fs.delete("a/b.bin")
        assert not fs.exists("a/b.bin")
        with pytest.raises(tst.StorageError):
            fs.load("a/b.bin")
        with pytest.raises(tst.StorageError):
            fs.save("../escape.bin", b"")


class TestIndexRoundTrip:
    @pytest.fixture(scope="class")
    def built(self):
        x = make_vectors(300, 32, seed=4)
        prov = InMemoryEmbeddingProvider(x, device="cpu")
        idx = LeannIndex(LeannConfig(**SMALL), device="cpu")
        idx.build(prov, with_pq=PQConfig(**PQ))
        return idx, x, prov

    def test_round_trip_search_identical(self, built, tmp_path):
        idx, x, prov = built
        path = tmp_path / "index.leann"
        nbytes = tst.save_index(idx, path)
        assert path.stat().st_size == nbytes
        idx2 = tst.load_index(path, device="cpu")
        assert (idx2.num_nodes, idx2.dimension, idx2.config) == (idx.num_nodes, idx.dimension,
                                                                 idx.config)
        q = make_vectors(8, 32, seed=77)
        d1, i1 = idx.search(q, k=5, provider=prov, ef=48)
        d2, i2 = idx2.search(q, k=5, provider=prov, ef=48)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)
        _, i3 = idx2.search_two_level(q, k=5, provider=prov, ef=48)
        assert i3.shape == (8, 5)

    def test_unbuilt_save_raises(self, tmp_path):
        with pytest.raises(tst.StorageError):
            tst.save_index(LeannIndex(device="cpu"), tmp_path / "x.leann")

    def test_sketch_round_trip(self, built, tmp_path):
        idx, x, prov = built
        assert idx.sketch is not None
        tst.save_index(idx, tmp_path / "sk.leann")
        idx2 = tst.load_index(tmp_path / "sk.leann", device="cpu")
        for a, b in ((idx2.sketch.node_sketch, idx.sketch.node_sketch),
                     (idx2.sketch.nbr_sketch, idx.sketch.nbr_sketch),
                     (idx2.sketch.w, idx.sketch.w)):
            assert torch.equal(a, b)
        q = make_vectors(8, 32, seed=78)
        d1, i1 = idx.search(q, k=5, provider=prov, ef=48, gate="sketch")
        d2, i2 = idx2.search(q, k=5, provider=prov, ef=48, gate="sketch")
        assert torch.equal(i1, i2) and torch.equal(d1, d2)

    def test_storage_parity_sketch_rederivation(self, built, tmp_path):
        # persist_sketch=False drops SKCH; the port's own recipe
        # (build_sketch_index from the seed) rebuilds its construction
        # sketch bit for bit.
        idx, x, prov = built
        full = tst.save_index(idx, tmp_path / "full.leann")
        parity = tst.save_index(idx, tmp_path / "parity.leann", persist_sketch=False)
        assert (full - parity) / idx.num_nodes >= idx.sketch.node_sketch.shape[1] * 4
        idx2 = tst.load_index(tmp_path / "parity.leann", device="cpu")
        assert idx2.sketch is None
        xp = dist_ops.prep_corpus(torch.from_numpy(x), idx2.config.metric)
        idx2.sketch = proj_ops.build_sketch_index(xp, idx2.graph.neighbors,
                                                  proj_dims=idx.sketch.proj_dims,
                                                  seed=idx2.config.seed)
        idx2._init_routing()
        assert torch.equal(idx2.sketch.node_sketch, idx.sketch.node_sketch)
        assert torch.equal(idx2.sketch.nbr_sketch, idx.sketch.nbr_sketch)
        assert float(idx2.sketch.scale) == float(idx.sketch.scale)
        q = make_vectors(8, 32, seed=79)
        d1, i1 = idx.search(q, k=5, provider=prov, ef=48, gate="sketch")
        d2, i2 = idx2.search(q, k=5, provider=prov, ef=48, gate="sketch")
        assert torch.equal(i1, i2) and torch.equal(d1, d2)
