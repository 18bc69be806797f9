"""models/cloud.py of the port: a mirror of tests/test_cloud_embeddings.py,
and request/response parity with the JAX package's module. No network call:
the request-building and response-parsing halves are tested against canned
payloads, and the network half is stubbed."""

import json

import numpy as np
import pytest

from islands_tpu.models import cloud as jcloud
from islands_tpu_torch.models.cloud import (
    KNOWN_DIMENSIONS,
    CloudEmbedder,
    CloudEmbeddingConfig,
    CloudEmbeddingError,
    CloudProvider,
    build_request,
    parse_response,
)


class TestRequestFormat:
    def test_openai_body_and_headers(self):
        cfg = CloudEmbeddingConfig(provider=CloudProvider.OPENAI)
        url, headers, body = build_request(cfg, ["a", "b"], api_key="sk-test")
        assert url == "https://api.openai.com/v1/embeddings"
        assert headers["Authorization"] == "Bearer sk-test"
        payload = json.loads(body)
        assert payload == {
            "model": "text-embedding-3-small",
            "input": ["a", "b"],
            "encoding_format": "float",
        }

    def test_cohere_body_and_headers(self):
        cfg = CloudEmbeddingConfig(provider=CloudProvider.COHERE,
                                   model="embed-english-light-v3.0")
        url, headers, body = build_request(cfg, ["x"], api_key="co-test")
        assert url == "https://api.cohere.com/v2/embed"
        assert headers["Authorization"] == "Bearer co-test"
        payload = json.loads(body)
        assert payload == {
            "model": "embed-english-light-v3.0",
            "texts": ["x"],
            "input_type": "search_document",
            "embedding_types": ["float"],
        }

    def test_base_url_override(self):
        cfg = CloudEmbeddingConfig(provider=CloudProvider.OPENAI,
                                   base_url="http://proxy:8080/v1/embeddings")
        url, _, _ = build_request(cfg, ["a"], api_key="k")
        assert url == "http://proxy:8080/v1/embeddings"


class TestResponseParse:
    def test_openai_index_sorted(self):
        raw = json.dumps({
            "data": [
                {"index": 1, "embedding": [3.0, 4.0]},
                {"index": 0, "embedding": [1.0, 2.0]},
            ],
            "model": "text-embedding-3-small",
        }).encode()
        out = parse_response(CloudProvider.OPENAI, raw, expected=2)
        np.testing.assert_array_equal(out, [[1.0, 2.0], [3.0, 4.0]])
        assert out.dtype == np.float32

    def test_cohere_float_block(self):
        raw = json.dumps({
            "embeddings": {"float": [[0.5, -0.5], [1.5, 2.5]]},
        }).encode()
        out = parse_response(CloudProvider.COHERE, raw, expected=2)
        np.testing.assert_array_equal(out, [[0.5, -0.5], [1.5, 2.5]])

    def test_count_mismatch_raises(self):
        raw = json.dumps({"data": [{"index": 0, "embedding": [1.0]}]}).encode()
        with pytest.raises(CloudEmbeddingError, match="expected 2"):
            parse_response(CloudProvider.OPENAI, raw, expected=2)

    def test_malformed_raises(self):
        with pytest.raises(CloudEmbeddingError):
            parse_response(CloudProvider.OPENAI, b"not json", expected=1)
        with pytest.raises(CloudEmbeddingError):
            parse_response(CloudProvider.COHERE, b'{"embeddings": 3}', expected=1)


class TestConfig:
    def test_key_from_env(self, monkeypatch):
        monkeypatch.setenv("COHERE_API_KEY", "env-key")
        cfg = CloudEmbeddingConfig(provider=CloudProvider.COHERE)
        assert cfg.resolved_key() == "env-key"

    def test_missing_key_raises(self, monkeypatch):
        monkeypatch.delenv("OPENAI_API_KEY", raising=False)
        with pytest.raises(CloudEmbeddingError, match="OPENAI_API_KEY"):
            CloudEmbeddingConfig(provider=CloudProvider.OPENAI).resolved_key()

    def test_known_dimensions(self):
        emb = CloudEmbedder(CloudEmbeddingConfig(
            provider=CloudProvider.OPENAI, model="text-embedding-3-large"))
        assert emb.dimension == KNOWN_DIMENSIONS["text-embedding-3-large"]

    def test_offline_batch_request_assembly(self, monkeypatch):
        """embed_texts batches through _call; stub the network half and check
        batching + concat semantics without egress."""
        emb = CloudEmbedder(CloudEmbeddingConfig(
            provider=CloudProvider.OPENAI, batch_size=2))
        calls = []

        def fake_call(texts):
            calls.append(list(texts))
            return np.full((len(texts), 3), float(len(calls)), np.float32)

        monkeypatch.setattr(emb, "_call", fake_call)
        out = emb.embed_texts(["a", "b", "c"])
        assert calls == [["a", "b"], ["c"]]
        assert out.shape == (3, 3)
        assert emb.dimension == 3

    def test_cohere_default_model_and_batch(self):
        # What the indexer's kind="cohere" embedding config builds (the
        # indexer service is not ported yet): the provider's default model,
        # resolved lazily, and the configured batch size.
        emb = CloudEmbedder(CloudEmbeddingConfig(provider=CloudProvider.COHERE, batch_size=7))
        assert emb.config.provider is CloudProvider.COHERE
        assert emb.config.resolved_model() == "embed-english-v3.0"
        assert emb.config.batch_size == 7
        assert emb.dimension == KNOWN_DIMENSIONS["embed-english-v3.0"]

    def test_empty_batch_makes_no_call(self, monkeypatch):
        emb = CloudEmbedder(CloudEmbeddingConfig(provider=CloudProvider.OPENAI))
        monkeypatch.setattr(emb, "_call", lambda texts: pytest.fail("network call"))
        assert emb.embed_texts([]).shape == (0, 1536)


class TestParityWithReference:
    @pytest.mark.parametrize("provider", ["openai", "cohere"])
    @pytest.mark.parametrize("model,base_url", [(None, None),
                                                ("embed-english-light-v3.0", "http://p:1/e")])
    def test_same_request(self, provider, model, base_url):
        kw = dict(model=model, base_url=base_url, input_type="search_query")
        t = CloudEmbeddingConfig(provider=CloudProvider(provider), **kw)
        j = jcloud.CloudEmbeddingConfig(provider=jcloud.CloudProvider(provider), **kw)
        assert build_request(t, ["a", "b c"], "k") == jcloud.build_request(j, ["a", "b c"], "k")

    def test_same_tables(self):
        assert KNOWN_DIMENSIONS == jcloud.KNOWN_DIMENSIONS
        assert [p.value for p in CloudProvider] == [p.value for p in jcloud.CloudProvider]
        assert CloudEmbeddingConfig().batch_size == jcloud.CloudEmbeddingConfig().batch_size

    def test_same_parse(self):
        raw = json.dumps({"data": [{"index": 2, "embedding": [5.0]},
                                   {"index": 0, "embedding": [1.0]},
                                   {"index": 1, "embedding": [3.0]}]}).encode()
        np.testing.assert_array_equal(
            parse_response(CloudProvider.OPENAI, raw, 3),
            jcloud.parse_response(jcloud.CloudProvider.OPENAI, raw, 3))
