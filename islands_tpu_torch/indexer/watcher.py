"""Filesystem watcher with per-repo debounce. Port of
islands_tpu/indexer/watcher.py.

Reference: `IndexWatcher` (src/indexer/watcher.rs:17-141) — notify-crate
recursive watcher, `.git` skipped, repo root = first 3 path components under
the watch root, per-repo debounce by restarting a sleep task.

With no inotify binding in the standard library, the watcher polls
mtimes on an interval (same observable contract: callback fires once per
repo, debounce_seconds after the last detected change)."""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Callable

ChangeCallback = Callable[[str], None]


def extract_repo_path(root: Path, changed: Path) -> str | None:
    """First 3 components under the watch root -> "provider/owner/name"
    (reference: extract_repo_path, watcher.rs:127-141)."""
    try:
        rel = changed.relative_to(root)
    except ValueError:
        return None
    parts = rel.parts
    if len(parts) < 3:
        return None
    return "/".join(parts[:3])


class IndexWatcher:
    """Polling watcher over the repos root; fires `callback(repo_path)` after
    `debounce_seconds` of quiet per repo."""

    def __init__(
        self,
        root: str | Path,
        callback: ChangeCallback,
        debounce_seconds: float = 2.0,
        poll_interval: float = 0.5,
    ):
        self.root = Path(root)
        self.callback = callback
        self.debounce_seconds = debounce_seconds
        self.poll_interval = poll_interval
        self._mtimes: dict[str, float] = {}
        self._pending: dict[str, float] = {}  # repo -> last change time
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _scan(self) -> dict[str, float]:
        """Max mtime per repo, skipping .git (reference skips .git events,
        watcher.rs:58-63)."""
        out: dict[str, float] = {}
        if not self.root.exists():
            return out
        for f in self.root.rglob("*"):
            if ".git" in f.parts:
                continue
            repo = extract_repo_path(self.root, f)
            if repo is None:
                continue
            try:
                mt = f.stat().st_mtime
            except OSError:
                continue
            if mt > out.get(repo, 0.0):
                out[repo] = mt
        return out

    def poll_once(self, now: float | None = None) -> list[str]:
        """One poll step; returns repos whose debounce fired (exposed for
        deterministic tests)."""
        now = time.monotonic() if now is None else now
        current = self._scan()
        for repo, mt in current.items():
            if mt != self._mtimes.get(repo):
                self._pending[repo] = now
        self._mtimes = current
        fired = [
            r for r, t in self._pending.items()
            if now - t >= self.debounce_seconds
        ]
        for r in fired:
            del self._pending[r]
            self.callback(r)
        return fired

    def start(self) -> None:
        if self._thread is not None:
            return
        self._mtimes = self._scan()  # baseline: don't fire for extant state
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval):
                try:
                    self.poll_once()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
