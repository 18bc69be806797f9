"""islands_tpu_torch: the PyTorch/CUDA port of islands_tpu.

It builds and queries the sketch-gated proximity-graph index on an NVIDIA
GPU, with the reference's host layers around it: the indexer service, the
git providers, the MCP stdio server, the RAG agent and the CLI
(`islands-tpu-torch`, or `python -m islands_tpu_torch.cli`). Entry points
run on CUDA unless `device="cpu"` is passed (`--device cpu` on the CLI),
and raise without a card. The package imports torch and numpy, never jax
and nothing of islands_tpu.
"""

__version__ = "0.1.0"

from islands_tpu_torch.core.config import (
    DistanceMetric,
    HnswConfig,
    LeannConfig,
    PQConfig,
    SearchConfig,
)
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.device import resolve_device

__all__ = [
    "CsrGraph",
    "DistanceMetric",
    "HnswConfig",
    "LeannConfig",
    "PQConfig",
    "SearchConfig",
    "__version__",
    "resolve_device",
]


def __getattr__(name):
    """Lazy heavyweight imports, as the reference's: `islands_tpu_torch.LeannIndex`
    etc. without paying model/indexer import costs at package import."""
    lazy = {
        "LeannIndex": ("islands_tpu_torch.core.leann", "LeannIndex"),
        "HnswIndex": ("islands_tpu_torch.core.hnsw", "HnswIndex"),
        "ProductQuantizer": ("islands_tpu_torch.core.pq", "ProductQuantizer"),
        "StoredSearcher": ("islands_tpu_torch.core.search", "StoredSearcher"),
        "InMemoryEmbeddingProvider": (
            "islands_tpu_torch.core.embedding", "InMemoryEmbeddingProvider"
        ),
        "save_index": ("islands_tpu_torch.core.storage", "save_index"),
        "load_index": ("islands_tpu_torch.core.storage", "load_index"),
        "IndexerService": ("islands_tpu_torch.indexer.service", "IndexerService"),
        "TextEncoder": ("islands_tpu_torch.models.encoder", "TextEncoder"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'islands_tpu_torch' has no attribute {name!r}")
