"""Repository manager: bounded-concurrency git clone/fetch. Port of
islands_tpu/indexer/manager.py.

Reference: src/indexer/manager.rs — path scheme repos/<provider>/<owner>/<name>
(:46-51), shallow clone depth 1 on a named branch returning the HEAD SHA
(:66-110, 196-210), fetch + fast-forward update comparing SHAs (:113-160,
213-234), and a semaphore bounding concurrent git operations (:17-42).

The reference uses libgit2 in spawn_blocking; here git runs as the `git` CLI
in subprocesses (the process boundary the reference crosses anyway), bounded
by a threading semaphore. Local-path remotes (plain directories / file://)
work offline, which is how the tests exercise this.
"""

from __future__ import annotations

import shutil
import subprocess
import threading
from pathlib import Path

from islands_tpu_torch.indexer.errors import CloneFailed, GitError, RepoNotFound
from islands_tpu_torch.providers.base import Repository


def _run_git(args: list[str], cwd: str | Path | None = None) -> str:
    try:
        proc = subprocess.run(
            ["git", *args],
            cwd=cwd,
            capture_output=True,
            text=True,
            timeout=300,
        )
    except FileNotFoundError as e:
        raise GitError("git executable not found") from e
    except subprocess.TimeoutExpired as e:
        raise GitError(f"git {' '.join(args[:2])} timed out") from e
    if proc.returncode != 0:
        raise GitError(
            f"git {' '.join(args[:2])} failed: {proc.stderr.strip()[:500]}"
        )
    return proc.stdout.strip()


class RepositoryManager:
    """Clone/update/remove repositories under a root directory."""

    def __init__(self, repos_path: str | Path, max_concurrent: int = 4):
        self.repos_path = Path(repos_path)
        self.repos_path.mkdir(parents=True, exist_ok=True)
        # Bounded concurrency (reference: tokio Semaphore(max_concurrent_syncs),
        # manager.rs:23,39).
        self._sem = threading.Semaphore(max_concurrent)

    def repo_path(self, repo: Repository) -> Path:
        """repos/<provider>/<owner>/<name> (reference: manager.rs:46-51)."""
        return self.repos_path / repo.provider / repo.owner / repo.name

    def is_cloned(self, repo: Repository) -> bool:
        return (self.repo_path(repo) / ".git").exists()

    def clone_repository(
        self, repo: Repository, branch: str | None = None, clone_url: str | None = None
    ) -> str:
        """Shallow-clone (depth 1) and return the HEAD commit SHA
        (reference: manager.rs:66-110,196-210). Replaces any existing copy."""
        path = self.repo_path(repo)
        with self._sem:
            if path.exists():
                shutil.rmtree(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            url = clone_url or repo.clone_url
            args = ["clone", "--depth", "1"]
            if branch:
                args += ["--branch", branch]
            args += [url, str(path)]
            try:
                _run_git(args)
            except GitError as e:
                raise CloneFailed(str(e)) from e
            return self.head_commit(repo)

    def update_repository(self, repo: Repository) -> tuple[str, bool]:
        """Fetch + fast-forward; returns (new_head_sha, changed)
        (reference: manager.rs:113-160,213-234)."""
        path = self.repo_path(repo)
        if not (path / ".git").exists():
            raise RepoNotFound(f"{repo.full_name} is not cloned")
        with self._sem:
            old = self.head_commit(repo)
            _run_git(["fetch", "--depth", "1", "origin"], cwd=path)
            # Fast-forward to the fetched head of the current branch.
            _run_git(["reset", "--hard", "FETCH_HEAD"], cwd=path)
            new = self.head_commit(repo)
            return new, new != old

    def head_commit(self, repo: Repository) -> str:
        return _run_git(["rev-parse", "HEAD"], cwd=self.repo_path(repo))

    def remove_repository(self, repo: Repository) -> bool:
        path = self.repo_path(repo)
        if path.exists():
            shutil.rmtree(path)
            # prune empty owner/provider dirs
            for parent in (path.parent, path.parent.parent):
                try:
                    parent.rmdir()
                except OSError:
                    break
            return True
        return False
