"""Indexer service: clone -> collect -> chunk -> embed -> index -> persist.

Port of islands_tpu/indexer/service.py. Reference: `IndexerService`
(src/indexer/service.rs:211-1150) — index CRUD, workspaces, webhook-driven
sync, background sync loop, file collection, metadata persistence.

Deliberate fixes over the reference (SURVEY.md §2.2):
- real chunking (512/64) instead of one-vector-per-file (service.rs:645);
- the actual index is persisted (index.leann via core/storage) and reloaded
  on startup — the reference only persists metadata.json, so its graphs are
  lost on restart (service.rs:259-268);
- `size_bytes` is the true on-disk index size, not the n*4*384 estimate
  (service.rs:571);
- search runs the LEANN two-level path when PQ is enabled (the reference
  builds/searches HnswGraph and never wires PQ in).

Host orchestration is plain Python threads (the reference is tokio); all
embedding and search compute runs on the service's device (CUDA unless
`device="cpu"`) through core/ and models/. The on-disk layout is the
reference's (index.leann, chunks.json, embeddings.npy or tokens.npz with
its center, metadata.json), so either package's service loads the other's
index directories.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from islands_tpu_torch.core.config import LeannConfig, PQConfig
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.storage import load_index, save_index
from islands_tpu_torch.device import resolve_device
from islands_tpu_torch.indexer.errors import (
    IndexNotFound,
    IndexingFailed,
    RepoNotFound,
    RepoNotInWorkspace,
    WorkspaceNotFound,
)
from islands_tpu_torch.indexer.files import (
    DEFAULT_EXTENSIONS,
    Chunk,
    chunk_files,
    collect_files,
)
from islands_tpu_torch.indexer.manager import RepositoryManager
from islands_tpu_torch.indexer.state import RepositoryState
from islands_tpu_torch.providers.base import Repository, WebhookEvent

logger = logging.getLogger("islands_tpu_torch.indexer")


# ---------------------------------------------------------------------------
# Config (reference: IndexerConfig service.rs:57-209, EmbeddingConfig :77-180)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EmbeddingConfig:
    """Tagged embedder choice (reference's Local/OpenAI/Cohere/Candle enum,
    provider.rs:76-102; here 'encoder' = BERT/ModernBERT on the device,
    'openai'/'cohere' = the cloud wire-format clients (models/cloud.py;
    api_key from OPENAI_API_KEY / COHERE_API_KEY), 'hash' = deterministic
    device-free test fallback)."""

    kind: str = "hash"  # "hash" | "encoder" | "openai" | "cohere"
    model: str = "bge-small"  # preset name or local HF path for "encoder"
    batch_size: int = 32  # reference default: service.rs:92
    dimension: int = 384  # used by "hash"
    # LEANN recompute mode (requires kind="encoder"): the service persists
    # the tokenized corpus instead of an [n, d] float matrix and answers
    # queries by recomputing embeddings during search — the deployment shape
    # the reference describes but never wires in (SURVEY.md §2.1 critical
    # wiring fact; provider.rs:450-472 leaves the id->text bridge
    # unimplemented).
    recompute: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class IndexerConfig:
    base_path: str = ".islands"
    # explicit location overrides (ISLANDS_REPOS_PATH / ISLANDS_INDEXES_PATH)
    repos_path_override: str | None = None
    indexes_path_override: str | None = None
    max_concurrent_syncs: int = 4  # reference: service.rs:195
    sync_interval_secs: int = 300  # reference: service.rs:196
    index_extensions: tuple = DEFAULT_EXTENSIONS
    chunk_size: int = 512  # islands.example.yaml:33
    chunk_overlap: int = 64  # islands.example.yaml:34
    embedding: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    use_native_loader: bool = True  # C++ walker/chunker with Python fallback
    leann: LeannConfig = dataclasses.field(
        default_factory=lambda: LeannConfig(
            m=16, m0=32, ef_construction=100, wave_size=512,
            intra_wave_k=16, reverse_slack=32,
        )
    )
    pq: PQConfig | None = None  # enable two-level search when set

    @property
    def repos_path(self) -> Path:
        if self.repos_path_override:
            return Path(self.repos_path_override)
        return Path(self.base_path) / "repos"

    @property
    def indexes_path(self) -> Path:
        if self.indexes_path_override:
            return Path(self.indexes_path_override)
        return Path(self.base_path) / "indexes"

    @property
    def workspaces_path(self) -> Path:
        return Path(self.base_path) / "workspaces"


@dataclasses.dataclass
class IndexInfo:
    """Per-index metadata (reference IndexInfo/StoredIndex info,
    service.rs:211-233)."""

    name: str
    repository: str  # owner/name
    provider: str = "local"
    num_files: int = 0
    num_chunks: int = 0
    dimension: int = 0
    commit: str | None = None
    indexed_at: float = 0.0
    size_bytes: int = 0
    mode: str = "stored"  # "stored" | "recompute" (see EmbeddingConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "IndexInfo":
        return IndexInfo(**d)


class StoredIndex:
    """In-memory handle: info + LEANN index + chunks + provider
    (InMemoryEmbeddingProvider for stored mode, EncoderEmbeddingProvider for
    recompute mode)."""

    def __init__(
        self,
        info: IndexInfo,
        index: LeannIndex | None = None,
        chunks: list[Chunk] | None = None,
        provider=None,
    ):
        self.info = info
        self.index = index
        self.chunks = chunks
        self.provider = provider

    @property
    def loaded(self) -> bool:
        return self.index is not None and self.provider is not None


class IndexerService:
    """Orchestrates repositories, indexes, workspaces, and search. Indexes
    and encoders live on `device` (CUDA unless "cpu"; raises without a
    card)."""

    def __init__(self, config: IndexerConfig | None = None, embedder=None, device=None):
        self.device = resolve_device(device)
        self.config = config or IndexerConfig()
        for p in (self.config.repos_path, self.config.indexes_path,
                  self.config.workspaces_path):
            p.mkdir(parents=True, exist_ok=True)
        self.manager = RepositoryManager(
            self.config.repos_path, self.config.max_concurrent_syncs
        )
        self._embedder = embedder  # injected or lazily constructed
        self.indexes: dict[str, StoredIndex] = {}
        self.states: dict[str, RepositoryState] = {}
        self.repos: dict[str, Repository] = {}
        self._lock = threading.RLock()
        self._sync_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._load_from_disk()

    # -- embedder ----------------------------------------------------------

    @property
    def embedder(self):
        """Lazy embedder init (reference: init_embedder, service.rs:351-433)."""
        if self._embedder is None:
            ec = self.config.embedding
            if ec.kind == "encoder":
                from islands_tpu_torch.models.encoder import TextEncoder

                if Path(ec.model).exists():
                    self._embedder = TextEncoder.from_pretrained(ec.model, device=self.device)
                else:
                    self._embedder = TextEncoder.from_preset(ec.model, device=self.device)
            elif ec.kind in ("openai", "cohere"):
                # Cloud backends (reference: CloudProvider {OpenAI, Cohere},
                # provider.rs:84-102); api_key from env per reference docs.
                from islands_tpu_torch.models.cloud import (
                    CloudEmbedder,
                    CloudEmbeddingConfig,
                    CloudProvider,
                )

                # ec.model's default ("bge-small") is a local preset name;
                # treat it as "use the provider's default cloud model".
                cloud_model = ec.model if ec.model not in ("", "bge-small") else None
                self._embedder = CloudEmbedder(CloudEmbeddingConfig(
                    provider=CloudProvider(ec.kind),
                    model=cloud_model,
                    batch_size=ec.batch_size,
                ))
            else:
                from islands_tpu_torch.models.encoder import HashEmbedder

                self._embedder = HashEmbedder(dimension=ec.dimension)
        return self._embedder

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        bs = self.config.embedding.batch_size
        outs = []
        for s in range(0, len(texts), bs):
            outs.append(np.asarray(self.embedder.embed_texts(texts[s : s + bs])))
        if not outs:
            return np.zeros((0, self.embedder.dimension), dtype=np.float32)
        return np.concatenate(outs)

    # -- persistence -------------------------------------------------------

    def _index_dir(self, name: str) -> Path:
        return self.config.indexes_path / name

    def _load_from_disk(self) -> None:
        """Startup re-scan (reference: service.rs:272-344) — but unlike the
        reference, the actual index bytes reload too (lazily)."""
        for d in sorted(self.config.indexes_path.iterdir()) if self.config.indexes_path.exists() else []:
            meta = d / "metadata.json"
            if not meta.exists():
                continue
            try:
                info = IndexInfo.from_dict(json.loads(meta.read_text()))
            except (json.JSONDecodeError, TypeError) as e:
                logger.warning("skipping corrupt metadata %s: %s", meta, e)
                continue
            self.indexes[info.name] = StoredIndex(info)
            st = RepositoryState(full_name=info.repository, last_commit=info.commit)
            st.indexed = True
            st.indexed_at = info.indexed_at
            self.states[info.repository] = st
        states_file = Path(self.config.base_path) / "states.json"
        if states_file.exists():
            try:
                for d in json.loads(states_file.read_text()):
                    st = RepositoryState.from_dict(d)
                    self.states[st.full_name] = st
            except (json.JSONDecodeError, TypeError):
                pass
        # Tracked repositories persist too — sync/webhook/remove must work
        # across process restarts, not only in the process that added them.
        repos_file = Path(self.config.base_path) / "repos.json"
        if repos_file.exists():
            try:
                for d in json.loads(repos_file.read_text()):
                    r = Repository.from_dict(d)
                    self.repos[r.full_name] = r
            except (json.JSONDecodeError, TypeError):
                pass

    def _save_states(self) -> None:
        states_file = Path(self.config.base_path) / "states.json"
        states_file.write_text(
            json.dumps([s.to_dict() for s in self.states.values()], indent=1)
        )
        repos_file = Path(self.config.base_path) / "repos.json"
        repos_file.write_text(
            json.dumps([r.to_dict() for r in self.repos.values()], indent=1)
        )

    def _persist_index(self, stored: StoredIndex) -> None:
        d = self._index_dir(stored.info.name)
        d.mkdir(parents=True, exist_ok=True)
        nbytes = save_index(stored.index, d / "index.leann")
        (d / "chunks.json").write_text(
            json.dumps([c.to_dict() for c in stored.chunks])
        )
        if stored.info.mode == "recompute":
            # LEANN storage contract on disk: graph + token table only — no
            # [n, d] float matrix anywhere (the ~95% storage reduction the
            # reference advertises, README.md:14, but never ships because its
            # service stores full HnswGraph embeddings, service.rs:614-623).
            save_kw = dict(
                token_ids=stored.provider.token_ids.cpu().numpy(),
                token_mask=stored.provider.token_mask.cpu().numpy(),
            )
            # Centered providers (with_center(), anisotropy fix) must reload
            # with the SAME center or post-restart query embeddings disagree
            # with the graph built from centered ones.
            center = getattr(stored.provider, "center", None)
            if center is not None and bool(torch.any(center != 0)):
                save_kw["center"] = center.cpu().numpy()
            np.savez(d / "tokens.npz", **save_kw)
            (d / "embeddings.npy").unlink(missing_ok=True)
        else:
            # Embedding cache: not part of the index (size_bytes charges only
            # index.leann) but saves a full corpus re-embed on restart.
            np.save(d / "embeddings.npy", stored.provider.embeddings.cpu().numpy())
        stored.info.size_bytes = nbytes
        (d / "metadata.json").write_text(json.dumps(stored.info.to_dict(), indent=1))

    def _ensure_loaded(self, stored: StoredIndex) -> StoredIndex:
        """Lazy reload of index bytes + chunk re-embedding after restart."""
        if stored.loaded:
            return stored
        d = self._index_dir(stored.info.name)
        idx_file = d / "index.leann"
        chunks_file = d / "chunks.json"
        if not idx_file.exists() or not chunks_file.exists():
            raise IndexNotFound(
                f"index {stored.info.name} has no persisted data; re-index"
            )
        stored.index = load_index(idx_file, device=self.device)
        stored.chunks = [Chunk.from_dict(c) for c in json.loads(chunks_file.read_text())]
        tok_file = d / "tokens.npz"
        emb_file = d / "embeddings.npy"
        if tok_file.exists():
            from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

            toks = np.load(tok_file)
            stored.provider = EncoderEmbeddingProvider(
                self.embedder, toks["token_ids"], toks["token_mask"],
                center=toks["center"] if "center" in toks.files else None,
            )
        elif emb_file.exists():
            stored.provider = InMemoryEmbeddingProvider(np.load(emb_file), device=self.device)
        else:  # legacy layout: recompute from chunk texts
            emb = self.embed_texts([c.text for c in stored.chunks])
            stored.provider = InMemoryEmbeddingProvider(emb, device=self.device)
        return stored

    # -- indexing ----------------------------------------------------------

    @staticmethod
    def index_name_for(repo_full_name: str) -> str:
        return repo_full_name.replace("/", "_")

    def index_local_path(
        self,
        path: str | Path,
        name: str,
        repository: str | None = None,
        provider: str = "local",
        commit: str | None = None,
    ) -> IndexInfo:
        """Index a local directory (the tail of `islands add` after clone;
        reference: index_repository_with_progress, service.rs:498-606)."""
        chunks = None
        if self.config.use_native_loader:
            from islands_tpu_torch.indexer.native import collect_chunks_native

            chunks = collect_chunks_native(
                path, self.config.index_extensions,
                self.config.chunk_size, self.config.chunk_overlap,
            )
        if chunks is None:  # Python fallback (no toolchain / native error)
            files = collect_files(path, self.config.index_extensions)
            chunks = chunk_files(
                files, self.config.chunk_size, self.config.chunk_overlap
            )
        if not chunks:
            raise IndexingFailed(f"no indexable content under {path}")
        num_files = len({c.path for c in chunks})
        logger.info("indexing %s: %d files, %d chunks", name, num_files, len(chunks))

        recompute = self.config.embedding.recompute
        if recompute and self.config.embedding.kind != "encoder":
            raise IndexingFailed("recompute mode requires embedding.kind='encoder'")
        if recompute:
            from islands_tpu_torch.core.embedding import materialize_embeddings
            from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

            chunk_provider = EncoderEmbeddingProvider.from_texts(
                self.embedder, [c.text for c in chunks]
            )
            # Embeddings exist only for the duration of construction
            # (LEANN's temp-embedding pass, leann.rs:560-580); what persists
            # is the graph + token table.
            emb = materialize_embeddings(chunk_provider, len(chunks),
                                         batch=self.config.embedding.batch_size)
        else:
            emb = self.embed_texts([c.text for c in chunks])
            chunk_provider = InMemoryEmbeddingProvider(emb, device=self.device)

        index = LeannIndex(self.config.leann, device=self.device)
        index.build_from_embeddings(emb, with_pq=self.config.pq)

        info = IndexInfo(
            name=name,
            repository=repository or name,
            provider=provider,
            num_files=num_files,
            num_chunks=len(chunks),
            dimension=int(emb.shape[1]),
            commit=commit,
            indexed_at=time.time(),
            mode="recompute" if recompute else "stored",
        )
        del emb
        stored = StoredIndex(info, index, chunks, chunk_provider)
        with self._lock:
            self.indexes[name] = stored
            self._persist_index(stored)
        return info

    def index_repository(self, repo: Repository) -> IndexInfo:
        """Index an already-cloned repository."""
        path = self.manager.repo_path(repo)
        if not path.exists():
            raise RepoNotFound(f"{repo.full_name} is not cloned")
        commit = self.manager.head_commit(repo)
        name = self.index_name_for(repo.full_name)
        try:
            info = self.index_local_path(
                path, name, repository=repo.full_name,
                provider=repo.provider, commit=commit,
            )
        except Exception as e:
            st = self.states.setdefault(
                repo.full_name, RepositoryState(full_name=repo.full_name)
            )
            st.mark_error(str(e))
            self._save_states()
            raise
        st = self.states.setdefault(
            repo.full_name, RepositoryState(full_name=repo.full_name)
        )
        st.mark_synced(commit)
        st.mark_indexed()
        self.repos[repo.full_name] = repo
        self._save_states()
        return info

    def add_repository(
        self, url: str, clone_url: str | None = None, branch: str | None = None
    ) -> IndexInfo:
        """Clone + index from a URL or local path (reference: commands.rs
        add_repository, :14-51)."""
        p = Path(url)
        if p.exists():  # local directory: index in place, no clone
            name = p.resolve().name
            return self.index_local_path(p, name, repository=name)
        repo = Repository.from_url(url)
        self.manager.clone_repository(repo, branch=branch, clone_url=clone_url)
        return self.index_repository(repo)

    # -- search (reference: service.rs:717-818) ----------------------------

    def search(
        self,
        query: str,
        index_names: list[str] | None = None,
        workspace: str | None = None,
        top_k: int = 10,
        ef: int | None = None,
        snippet_chars: int = 200,
    ) -> list[dict]:
        """Embed the query, search each target index, merge by score desc.

        Returns dicts {index, path, start_line, end_line, snippet, score}
        with score = 1 - distance and `snippet_chars`-truncated snippets
        (reference default 200, service.rs:788-814; the agent requests more
        context)."""
        with self._lock:
            if workspace is not None:
                targets = self.get_workspace_index_names(workspace)
            elif index_names is not None:
                targets = index_names
            else:
                targets = list(self.indexes)
        if not targets:
            return []
        q = self.embed_texts([query])
        results: list[dict] = []
        for name in targets:
            stored = self.indexes.get(name)
            if stored is None:
                continue
            stored = self._ensure_loaded(stored)
            idx = stored.index
            if idx.is_empty:
                continue
            eff_ef = ef if ef is not None else max(top_k, 100)
            if idx.pq is not None:
                dists, ids = idx.search_two_level(
                    q, k=top_k, provider=stored.provider, ef=eff_ef
                )
            else:
                dists, ids = idx.search(q, k=top_k, provider=stored.provider, ef=eff_ef)
            for d, i in zip(dists[0].cpu().numpy(), ids[0].cpu().numpy()):
                if i < 0 or not np.isfinite(d):
                    continue
                c = stored.chunks[int(i)]
                results.append({
                    "index": name,
                    "path": c.path,
                    "start_line": c.start_line,
                    "end_line": c.end_line,
                    "snippet": c.text[:snippet_chars],
                    "score": float(1.0 - d),
                })
        results.sort(key=lambda r: -r["score"])
        return results[:top_k]

    # -- index CRUD (reference: service.rs:821-905) ------------------------

    def list_indexes(self) -> list[IndexInfo]:
        with self._lock:
            return [s.info for s in self.indexes.values()]

    def get_index(self, name: str) -> IndexInfo:
        with self._lock:
            if name not in self.indexes:
                raise IndexNotFound(name)
            return self.indexes[name].info

    def remove_index(self, name: str) -> None:
        with self._lock:
            if name not in self.indexes:
                raise IndexNotFound(name)
            stored = self.indexes.pop(name)
            shutil.rmtree(self._index_dir(name), ignore_errors=True)
            self.states.pop(stored.info.repository, None)
            repo = self.repos.pop(stored.info.repository, None)
            if repo is not None:
                self.manager.remove_repository(repo)
            self._save_states()

    def status(self) -> dict:
        """Aggregate counts/sizes (reference: commands.rs:296-315)."""
        with self._lock:
            infos = [s.info for s in self.indexes.values()]
        return {
            "num_indexes": len(infos),
            "total_chunks": sum(i.num_chunks for i in infos),
            "total_files": sum(i.num_files for i in infos),
            "total_size_bytes": sum(i.size_bytes for i in infos),
            "indexes": [i.to_dict() for i in infos],
        }

    # -- workspaces (reference: service.rs:908-1026) -----------------------

    def _workspace_file(self, name: str) -> Path:
        return self.config.workspaces_path / name / "workspace.json"

    def create_workspace(self, name: str, description: str = "") -> dict:
        ws = {
            "name": name,
            "description": description,
            "repositories": [],
            "created_at": time.time(),
        }
        f = self._workspace_file(name)
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(json.dumps(ws, indent=1))
        return ws

    def get_workspace(self, name: str) -> dict:
        f = self._workspace_file(name)
        if not f.exists():
            raise WorkspaceNotFound(name)
        return json.loads(f.read_text())

    def list_workspaces(self) -> list[dict]:
        if not self.config.workspaces_path.exists():
            return []
        out = []
        for d in sorted(self.config.workspaces_path.iterdir()):
            f = d / "workspace.json"
            if f.exists():
                out.append(json.loads(f.read_text()))
        return out

    def delete_workspace(self, name: str) -> None:
        f = self._workspace_file(name)
        if not f.exists():
            raise WorkspaceNotFound(name)
        shutil.rmtree(f.parent)

    def add_repo_to_workspace(self, workspace: str, repo_full_name: str) -> dict:
        ws = self.get_workspace(workspace)
        if repo_full_name not in ws["repositories"]:
            ws["repositories"].append(repo_full_name)
            self._workspace_file(workspace).write_text(json.dumps(ws, indent=1))
        return ws

    def remove_repo_from_workspace(self, workspace: str, repo_full_name: str) -> dict:
        ws = self.get_workspace(workspace)
        if repo_full_name not in ws["repositories"]:
            raise RepoNotInWorkspace(f"{repo_full_name} not in {workspace}")
        ws["repositories"].remove(repo_full_name)
        self._workspace_file(workspace).write_text(json.dumps(ws, indent=1))
        return ws

    def get_workspace_index_names(self, workspace: str) -> list[str]:
        """(reference: service.rs:956-964)"""
        ws = self.get_workspace(workspace)
        return [self.index_name_for(r) for r in ws["repositories"]]

    # -- sync (reference: service.rs:1029-1080) ----------------------------

    def sync_repository(self, full_name: str) -> bool:
        """Fetch; re-index if the commit changed or state needs it. Returns
        True if a re-index happened."""
        repo = self.repos.get(full_name)
        if repo is None:
            raise RepoNotFound(full_name)
        st = self.states.setdefault(full_name, RepositoryState(full_name=full_name))
        try:
            commit, changed = self.manager.update_repository(repo)
            st.mark_synced(commit)
            if changed or st.needs_reindex():
                self.index_repository(repo)
                return True
            return False
        except Exception as e:
            st.mark_error(str(e))
            self._save_states()
            logger.error("sync failed for %s: %s", full_name, e)
            return False

    def sync_all(self) -> int:
        """Sync every tracked repository; per-repo failures logged and
        skipped (reference: service.rs:1067-1069). Returns reindex count."""
        count = 0
        for full_name in list(self.repos):
            if self.sync_repository(full_name):
                count += 1
        return count

    def handle_webhook(self, event: WebhookEvent) -> bool:
        """Push events trigger a sync (reference: service.rs:1029-1035)."""
        if not event.is_push():
            return False
        full_name = event.repository.full_name
        if full_name not in self.repos:
            return False
        return self.sync_repository(full_name)

    def start_watcher(self, debounce_seconds: float = 2.0):
        """Filesystem watcher over the repos root: a debounced change to
        provider/owner/name triggers re-index of that repository (reference:
        IndexWatcher wiring, src/indexer/watcher.rs:17-124)."""
        from islands_tpu_torch.indexer.watcher import IndexWatcher

        def on_change(repo_path: str) -> None:
            full_name = "/".join(repo_path.split("/")[1:3])
            repo = self.repos.get(full_name)
            if repo is not None:
                try:
                    self.index_repository(repo)
                except Exception as e:
                    logger.error("watcher reindex failed for %s: %s", full_name, e)

        watcher = IndexWatcher(
            self.config.repos_path, on_change, debounce_seconds=debounce_seconds
        )
        watcher.start()
        return watcher

    def start_sync_loop(self) -> None:
        """Background interval sync (reference: service.rs:1038-1080)."""
        if self._sync_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.sync_interval_secs):
                try:
                    self.sync_all()
                except Exception as e:  # keep the loop alive
                    logger.error("sync loop error: %s", e)

        self._sync_thread = threading.Thread(target=loop, daemon=True)
        self._sync_thread.start()

    def stop_sync_loop(self) -> None:
        self._stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=5)
            self._sync_thread = None
