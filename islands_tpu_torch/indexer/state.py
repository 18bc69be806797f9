"""Per-repository sync/index state. Port of islands_tpu/indexer/state.py
(reference: src/indexer/state.rs:11-74)."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class RepositoryState:
    """Tracking record for one repository."""

    full_name: str
    last_commit: str | None = None
    last_synced: float | None = None
    indexed: bool = False
    indexed_at: float | None = None
    error: str | None = None

    def needs_reindex(self) -> bool:
        """!indexed or error present (reference: state.rs:52-73)."""
        return not self.indexed or self.error is not None

    def mark_synced(self, commit: str) -> None:
        changed = self.last_commit is not None and self.last_commit != commit
        self.last_commit = commit
        self.last_synced = time.time()
        if changed:
            self.indexed = False

    def mark_indexed(self) -> None:
        self.indexed = True
        self.indexed_at = time.time()
        self.error = None

    def mark_error(self, message: str) -> None:
        self.error = message

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "RepositoryState":
        return RepositoryState(**d)
