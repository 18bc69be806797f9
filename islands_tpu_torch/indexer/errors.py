"""Indexer error hierarchy. Port of islands_tpu/indexer/errors.py
(reference: src/indexer/error.rs:12-64)."""

from __future__ import annotations


class IndexerError(Exception):
    """Base indexer error."""


class GitError(IndexerError):
    pass


class RepoNotFound(IndexerError):
    pass


class RepoExists(IndexerError):
    pass


class CloneFailed(IndexerError):
    pass


class IndexNotFound(IndexerError):
    pass


class WorkspaceNotFound(IndexerError):
    pass


class RepoNotInWorkspace(IndexerError):
    pass


class IndexingFailed(IndexerError):
    pass


class SyncError(IndexerError):
    pass
