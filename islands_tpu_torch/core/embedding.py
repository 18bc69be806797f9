"""Embedding providers: the id -> embedding recompute boundary.

Port of islands_tpu/core/embedding.py. A provider maps ids to embeddings on
its own device: `embed(ids [...] int) -> [..., d] float32`, so the search
loop asks for a whole hop's rows ([B, E] ids -> [B, E, d]) in one call. The
reference splits this into a static `embed_fn` and an `embed_ctx` pytree
only so that `jit` can hash the function; the port runs eagerly and keeps
one method. Out-of-range ids may return arbitrary rows (callers mask them).
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

from islands_tpu_torch.device import resolve_device, to_device


class EmbeddingError(ValueError):
    """Provider failure."""


@runtime_checkable
class EmbeddingProvider(Protocol):
    """id -> embedding computation."""

    @property
    def dimension(self) -> int: ...

    @property
    def num_items(self) -> int: ...

    @property
    def device(self) -> torch.device: ...

    def embed(self, ids: torch.Tensor) -> torch.Tensor: ...

    def compute_embedding(self, item_id: int) -> np.ndarray: ...

    def compute_embeddings_batch(self, ids) -> np.ndarray: ...


class InMemoryEmbeddingProvider:
    """Tensor-backed provider: a clamped row gather over stored embeddings
    [n, d]. Runs on CUDA unless `device="cpu"`."""

    def __init__(self, embeddings, device=None):
        self._device = resolve_device(device)
        x = to_device(embeddings, self._device, torch.float32)
        if x.dim() != 2:
            raise EmbeddingError("embeddings must be [n, d]")
        self._x = x

    @property
    def dimension(self) -> int:
        return self._x.shape[1]

    @property
    def num_items(self) -> int:
        return self._x.shape[0]

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def embeddings(self) -> torch.Tensor:
        return self._x

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self._x[torch.clamp(ids.long(), 0, self._x.shape[0] - 1)]

    def compute_embedding(self, item_id: int) -> np.ndarray:
        if not 0 <= item_id < self.num_items:
            raise EmbeddingError(f"id {item_id} out of range [0, {self.num_items})")
        return self._x[item_id].cpu().numpy()

    def compute_embeddings_batch(self, ids) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_items):
            raise EmbeddingError("id out of range")
        return self._x[torch.from_numpy(ids).to(self._device)].cpu().numpy()


class CallableEmbeddingProvider:
    """Wraps a function `ids -> [..., d]` (an encoder forward, say) whose
    outputs lie on `device`."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], dimension: int,
                 num_items: int, device=None):
        self._fn = fn
        self._dimension = dimension
        self._num_items = num_items
        self._device = resolve_device(device)

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def num_items(self) -> int:
        return self._num_items

    @property
    def device(self) -> torch.device:
        return self._device

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self._fn(ids)

    def compute_embedding(self, item_id: int) -> np.ndarray:
        ids = torch.tensor([item_id], dtype=torch.int32, device=self._device)
        return self._fn(ids)[0].cpu().numpy()

    def compute_embeddings_batch(self, ids) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=self._device)
        return self._fn(ids).cpu().numpy()


def materialize_embeddings(provider: EmbeddingProvider, n: int,
                           batch: int = 1024) -> torch.Tensor:
    """Pull the first n embeddings through the provider in batches: the
    build's temporary embedding pass. -> [n, d] on the provider's device."""
    dev = provider.device
    outs = [provider.embed(torch.arange(s, min(s + batch, n), dtype=torch.int32,
                                        device=dev)).float()
            for s in range(0, n, batch)]
    if not outs:
        return torch.zeros((0, provider.dimension), dtype=torch.float32, device=dev)
    return torch.cat(outs) if len(outs) > 1 else outs[0]
