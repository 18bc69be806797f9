"""Indexer service layer (reference: src/indexer/): repository management,
file collection and chunking (with the native C++ loader), index
build/persist/search, workspaces, sync."""

from islands_tpu_torch.indexer.errors import (
    CloneFailed,
    GitError,
    IndexerError,
    IndexingFailed,
    IndexNotFound,
    RepoExists,
    RepoNotFound,
    RepoNotInWorkspace,
    SyncError,
    WorkspaceNotFound,
)
from islands_tpu_torch.indexer.files import (
    DEFAULT_EXTENSIONS,
    Chunk,
    chunk_files,
    chunk_text,
    collect_files,
    iter_source_files,
    matches_extension,
)
from islands_tpu_torch.indexer.manager import RepositoryManager
from islands_tpu_torch.indexer.native import collect_chunks_native, native_available
from islands_tpu_torch.indexer.service import (
    EmbeddingConfig,
    IndexerConfig,
    IndexerService,
    IndexInfo,
    StoredIndex,
)
from islands_tpu_torch.indexer.state import RepositoryState
from islands_tpu_torch.indexer.watcher import IndexWatcher, extract_repo_path

__all__ = [
    "Chunk", "CloneFailed", "DEFAULT_EXTENSIONS", "EmbeddingConfig",
    "GitError", "IndexInfo", "IndexNotFound", "IndexWatcher", "IndexerConfig",
    "IndexerError", "IndexerService", "IndexingFailed", "RepoExists",
    "RepoNotFound", "RepoNotInWorkspace", "RepositoryManager",
    "RepositoryState", "StoredIndex", "SyncError", "WorkspaceNotFound",
    "chunk_files", "chunk_text", "collect_chunks_native", "collect_files",
    "extract_repo_path", "iter_source_files", "matches_extension", "native_available",
]
