"""Cloud embedding backends: OpenAI and Cohere wire-format clients.

Port of islands_tpu/models/cloud.py, on `urllib`. API keys default to the
OPENAI_API_KEY / COHERE_API_KEY environment variables. The request-building
and response-parsing halves are pure functions, tested against canned
payloads with no network call.

These embedders have the `embed_texts / embed_text / dimension` surface of
TextEncoder and HashEmbedder.
"""

from __future__ import annotations

import dataclasses
import json
import os
import urllib.request
from enum import Enum

import numpy as np


class CloudEmbeddingError(Exception):
    """A cloud embedding call or its response failed."""


class CloudProvider(str, Enum):
    OPENAI = "openai"
    COHERE = "cohere"


#: Published embedding dimensions per model (probed lazily for unknown
#: models by embedding "test").
KNOWN_DIMENSIONS = {
    "text-embedding-3-small": 1536,
    "text-embedding-3-large": 3072,
    "text-embedding-ada-002": 1536,
    "embed-english-v3.0": 1024,
    "embed-english-light-v3.0": 384,
    "embed-multilingual-v3.0": 1024,
}

_ENV_KEYS = {
    CloudProvider.OPENAI: "OPENAI_API_KEY",
    CloudProvider.COHERE: "COHERE_API_KEY",
}
_DEFAULT_MODELS = {
    CloudProvider.OPENAI: "text-embedding-3-small",
    CloudProvider.COHERE: "embed-english-v3.0",
}
_DEFAULT_URLS = {
    CloudProvider.OPENAI: "https://api.openai.com/v1/embeddings",
    CloudProvider.COHERE: "https://api.cohere.com/v2/embed",
}


@dataclasses.dataclass
class CloudEmbeddingConfig:
    provider: CloudProvider = CloudProvider.OPENAI
    model: str | None = None  # provider default when None
    api_key: str | None = None  # falls back to the provider's env var
    base_url: str | None = None
    batch_size: int = 96
    # Cohere distinguishes document vs query embeddings; OpenAI ignores it.
    input_type: str = "search_document"

    def resolved_model(self) -> str:
        return self.model or _DEFAULT_MODELS[self.provider]

    def resolved_key(self) -> str:
        key = self.api_key or os.environ.get(_ENV_KEYS[self.provider], "")
        if not key:
            raise CloudEmbeddingError(
                f"{self.provider.value} embeddings need api_key or "
                f"{_ENV_KEYS[self.provider]}"
            )
        return key

    def resolved_url(self) -> str:
        return self.base_url or _DEFAULT_URLS[self.provider]


# -- pure wire-format halves (tested without network) -----------------------


def build_request(config: CloudEmbeddingConfig, texts: list[str],
                  api_key: str) -> tuple[str, dict, bytes]:
    """-> (url, headers, body) for one embedding batch."""
    model = config.resolved_model()
    if config.provider is CloudProvider.OPENAI:
        body = {"model": model, "input": texts, "encoding_format": "float"}
        headers = {
            "Authorization": f"Bearer {api_key}",
            "Content-Type": "application/json",
        }
    else:
        body = {
            "model": model,
            "texts": texts,
            "input_type": config.input_type,
            "embedding_types": ["float"],
        }
        headers = {
            "Authorization": f"Bearer {api_key}",
            "Content-Type": "application/json",
        }
    return config.resolved_url(), headers, json.dumps(body).encode()


def parse_response(provider: CloudProvider, raw: bytes,
                   expected: int) -> np.ndarray:
    """Provider response JSON -> [expected, dim] float32. OpenAI returns
    `data: [{index, embedding}]` (index-sorted for safety); Cohere v2 returns
    `embeddings: {float: [[...]]}`."""
    try:
        payload = json.loads(raw)
    except json.JSONDecodeError as e:
        raise CloudEmbeddingError(f"malformed embeddings response: {e}") from e
    try:
        if provider is CloudProvider.OPENAI:
            rows = sorted(payload["data"], key=lambda r: r["index"])
            vecs = [r["embedding"] for r in rows]
        else:
            vecs = payload["embeddings"]["float"]
    except (KeyError, TypeError) as e:
        raise CloudEmbeddingError(f"malformed embeddings response: {e}") from e
    if len(vecs) != expected:
        raise CloudEmbeddingError(
            f"expected {expected} embeddings, got {len(vecs)}")
    return np.asarray(vecs, dtype=np.float32)


class CloudEmbedder:
    """API-backed embedder. Needs network access and an API key at run
    time."""

    def __init__(self, config: CloudEmbeddingConfig | None = None):
        self.config = config or CloudEmbeddingConfig()
        self._dimension = KNOWN_DIMENSIONS.get(self.config.resolved_model())

    @property
    def dimension(self) -> int:
        if self._dimension is None:
            # Probe by embedding one text.
            self._dimension = int(self.embed_texts(["test"]).shape[1])
        return self._dimension

    def _call(self, texts: list[str]) -> np.ndarray:  # pragma: no cover - network
        url, headers, body = build_request(
            self.config, texts, self.config.resolved_key())
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return parse_response(self.config.provider, r.read(), len(texts))

    def embed_texts(self, texts: list[str]) -> np.ndarray:  # pragma: no cover - network
        if not texts:
            dim = self._dimension or 0
            return np.zeros((0, dim), dtype=np.float32)
        out = []
        bs = self.config.batch_size
        for s in range(0, len(texts), bs):
            out.append(self._call(texts[s : s + bs]))
        emb = np.concatenate(out, axis=0)
        self._dimension = emb.shape[1]
        return emb

    def embed_text(self, text: str) -> np.ndarray:  # pragma: no cover - network
        return self.embed_texts([text])[0]
