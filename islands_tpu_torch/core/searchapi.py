"""High-level search API: results, a configurable searcher, a multi-index
merge.

Port of islands_tpu/core/searchapi.py. `Searcher` works over any index with
`search(queries, k, ef, ...) -> (dists, ids)` (HnswIndex, StoredSearcher,
...); the indexes answer with tensors, which become numpy and Python
numbers at this boundary. Queries may be numpy arrays or tensors, [B, d] or
[d].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from islands_tpu_torch.core.config import SearchConfig, distance_to_similarity


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class SearchResult:
    """One hit."""

    id: int
    distance: float
    vector: np.ndarray | None = None
    metadata: dict[str, Any] | None = None
    index_name: str | None = None

    @property
    def similarity(self) -> float:
        """1 / (1 + distance)."""
        return distance_to_similarity(self.distance)


class Searcher:
    """Configurable searcher over one index."""

    def __init__(self, index, config: SearchConfig | None = None):
        self.index = index
        self.config = config or SearchConfig()
        self.config.validate()

    def _replace(self, validate: bool = True, **kw) -> "Searcher":
        self.config = dataclasses.replace(self.config, **kw)
        if validate:
            self.config.validate()
        return self

    def with_top_k(self, top_k: int) -> "Searcher":
        return self._replace(top_k=top_k)

    def with_ef(self, ef: int) -> "Searcher":
        return self._replace(ef=ef)

    def with_min_similarity(self, s: float | None) -> "Searcher":
        return self._replace(validate=False, min_similarity=s)

    def with_vectors(self, include: bool = True) -> "Searcher":
        return self._replace(validate=False, include_vectors=include)

    def with_promote_width(self, promote_width: int | None) -> "Searcher":
        """Exact-scoring budget per hop, for indexes whose search takes it."""
        return self._replace(promote_width=promote_width)

    def with_max_iters(self, max_iters: int | None) -> "Searcher":
        """Hop cap, for indexes whose search takes it."""
        return self._replace(max_iters=max_iters)

    def search(self, queries) -> list[list[SearchResult]]:
        """queries [B, d] or [d] -> per-query hits, ascending distance,
        without empty slots and below-`min_similarity` hits."""
        q = queries if isinstance(queries, torch.Tensor) else np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        # Only set knobs are passed on: plain HNSW takes neither.
        kw = {}
        if self.config.promote_width is not None:
            kw["promote_width"] = self.config.promote_width
        if self.config.max_iters is not None:
            kw["max_iters"] = self.config.max_iters
        dists, ids = self.index.search(q, k=self.config.top_k, ef=self.config.ef, **kw)
        dists, ids = _to_numpy(dists), _to_numpy(ids)
        out: list[list[SearchResult]] = []
        for bi in range(len(q)):
            hits = []
            for d, i in zip(dists[bi], ids[bi]):
                if i < 0 or not np.isfinite(d):
                    continue
                r = SearchResult(id=int(i), distance=float(d))
                if (self.config.min_similarity is not None
                        and r.similarity < self.config.min_similarity):
                    continue
                if self.config.include_vectors and hasattr(self.index, "get_vector"):
                    r.vector = _to_numpy(self.index.get_vector(int(i)))
                hits.append(r)
            out.append(hits)
        return [out[0]] if single else out


class MultiIndexSearcher:
    """Search several named indexes and merge the hits by similarity."""

    def __init__(self, config: SearchConfig | None = None):
        self.config = config or SearchConfig()
        self.indexes: dict[str, Any] = {}

    def add_index(self, name: str, index) -> "MultiIndexSearcher":
        self.indexes[name] = index
        return self

    def remove_index(self, name: str) -> "MultiIndexSearcher":
        self.indexes.pop(name, None)
        return self

    def search(self, queries, index_names: list[str] | None = None) -> list[list[SearchResult]]:
        """Each index's hits, merged by similarity (descending, stable) and
        cut to top_k."""
        q = queries if isinstance(queries, torch.Tensor) else np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        names = index_names if index_names is not None else list(self.indexes)
        merged: list[list[SearchResult]] = [[] for _ in range(len(q))]
        for name in names:
            idx = self.indexes.get(name)
            if idx is None:
                continue
            for bi, hits in enumerate(Searcher(idx, self.config).search(q)):
                for h in hits:
                    h.index_name = name
                merged[bi].extend(hits)
        for bi in range(len(q)):
            merged[bi].sort(key=lambda r: -r.similarity)
            merged[bi] = merged[bi][: self.config.top_k]
        return [merged[0]] if single else merged
