"""Indexer host layer: file collection and chunking (config 1's feed) and
the native C++ loader. The service, manager, state and watcher are still to
be ported."""

from islands_tpu_torch.indexer.files import (
    DEFAULT_EXTENSIONS,
    Chunk,
    chunk_files,
    chunk_text,
    collect_files,
    iter_source_files,
    matches_extension,
)
from islands_tpu_torch.indexer.native import collect_chunks_native, native_available

__all__ = [
    "Chunk", "DEFAULT_EXTENSIONS", "chunk_files", "chunk_text", "collect_chunks_native",
    "collect_files", "iter_source_files", "matches_extension", "native_available",
]
