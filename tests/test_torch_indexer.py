"""The port's indexer service chain against tests/test_indexer.py's cases.

Repository state, the git manager over a local origin, the service's
index lifecycle with persistence and reload, recompute mode with the tiny
encoder, workspaces, webhook-driven sync, the watcher's debounce and the
review regressions, all on the CPU with no network. The last cases hold
the on-disk layout to the reference's: each package's service loads an
index directory the other's wrote and returns the same hits."""

import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from islands_tpu.indexer import IndexerConfig as JIndexerConfig
from islands_tpu.indexer import IndexerService as JIndexerService
from islands_tpu_torch.indexer import (
    IndexerConfig,
    IndexerService,
    IndexingFailed,
    IndexNotFound,
    IndexWatcher,
    RepositoryManager,
    RepositoryState,
    WorkspaceNotFound,
    extract_repo_path,
)
from islands_tpu_torch.indexer.service import EmbeddingConfig
from islands_tpu_torch.models.encoder import TextEncoder
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider
from islands_tpu_torch.providers import Repository, WebhookEvent


def make_tree(root: Path, files: dict[str, str]):
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)


SAMPLE = {
    "src/main.py": "def main():\n    print('hello world')\n",
    "src/search.py": "def search_index(query):\n    return beam_search(query)\n",
    "lib/util.rs": "fn distance(a: &[f32], b: &[f32]) -> f32 { 0.0 }\n",
    "README.md": "# Sample\nsemantic code search engine\n",
    "node_modules/dep.js": "module.exports = {}\n",
    "target/debug/out.rs": "fn ignored() {}\n",
    ".hidden/secret.py": "x = 1\n",
    "image.png": "not text",
}


def _git(args, cwd):
    subprocess.run(
        ["git", *args], cwd=cwd, check=True, capture_output=True,
        env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
             "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
             "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(cwd)},
    )


@pytest.fixture
def origin(tmp_path):
    """A local 'remote' git repository with sample content."""
    origin = tmp_path / "origin"
    origin.mkdir()
    make_tree(origin, {k: v for k, v in SAMPLE.items() if not k.startswith(".hidden/")})
    _git(["init", "-b", "main"], origin)
    _git(["add", "-A"], origin)
    _git(["commit", "-m", "init"], origin)
    return origin


@pytest.fixture
def svc(tmp_path):
    return IndexerService(IndexerConfig(base_path=str(tmp_path / "islands")), device="cpu")


class TestRepositoryState:
    def test_needs_reindex_transitions(self):
        st = RepositoryState(full_name="o/r")
        assert st.needs_reindex()
        st.mark_synced("abc")
        st.mark_indexed()
        assert not st.needs_reindex()
        st.mark_error("boom")
        assert st.needs_reindex()
        st.mark_indexed()
        assert not st.needs_reindex()
        st.mark_synced("def")
        assert st.needs_reindex()

    def test_round_trip(self):
        st = RepositoryState(full_name="o/r", last_commit="abc", indexed=True)
        assert RepositoryState.from_dict(st.to_dict()) == st


class TestRepositoryManager:
    def test_clone_update_remove(self, tmp_path, origin):
        mgr = RepositoryManager(tmp_path / "repos")
        repo = Repository.new("local", "owner", "sample", str(origin))
        sha = mgr.clone_repository(repo)
        assert len(sha) == 40
        assert mgr.is_cloned(repo)
        assert (mgr.repo_path(repo) / "src" / "main.py").exists()
        sha2, changed = mgr.update_repository(repo)
        assert sha2 == sha and not changed
        (origin / "new.py").write_text("print('new')\n")
        _git(["add", "-A"], origin)
        _git(["commit", "-m", "more"], origin)
        sha3, changed = mgr.update_repository(repo)
        assert changed and sha3 != sha
        assert (mgr.repo_path(repo) / "new.py").exists()
        assert mgr.remove_repository(repo)
        assert not mgr.is_cloned(repo)


class TestIndexerService:
    def test_entry_point_defaults_to_cuda(self, tmp_path):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IndexerService(IndexerConfig(base_path=str(tmp_path / "islands")))

    def test_index_and_search(self, svc, tmp_path):
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        info = svc.index_local_path(src, "proj")
        assert info.num_chunks >= 4
        assert info.size_bytes > 0
        hits = svc.search("beam search query function", top_k=5)
        assert hits
        assert any("search" in h["path"] for h in hits)
        for h in hits:
            assert {"index", "path", "snippet", "score", "start_line"} <= set(h)
        scores = [h["score"] for h in hits]
        assert scores == sorted(scores, reverse=True)

    def test_empty_dir_fails(self, svc, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(IndexingFailed):
            svc.index_local_path(empty, "empty")

    def test_persistence_reload(self, svc, tmp_path):
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        before = svc.search("distance between vectors", top_k=3)
        svc2 = IndexerService(IndexerConfig(base_path=svc.config.base_path), device="cpu")
        assert [i.name for i in svc2.list_indexes()] == ["proj"]
        after = svc2.search("distance between vectors", top_k=3)
        assert after == before

    def test_remove_index(self, svc, tmp_path):
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        svc.remove_index("proj")
        assert svc.list_indexes() == []
        assert not (Path(svc.config.base_path) / "indexes" / "proj").exists()
        with pytest.raises(IndexNotFound):
            svc.get_index("proj")

    def test_status(self, svc, tmp_path):
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        st = svc.status()
        assert st["num_indexes"] == 1
        assert st["total_chunks"] > 0
        assert st["total_size_bytes"] > 0

    def test_add_repository_local_git(self, svc, origin):
        info = svc.add_repository(str(origin))
        assert info.num_chunks > 0
        assert svc.search("hello world main", top_k=3)

    def test_full_repo_flow_with_sync_and_webhook(self, svc, origin):
        repo = Repository.new("local", "owner", "sample", str(origin))
        svc.manager.clone_repository(repo)
        svc.index_repository(repo)
        name = svc.index_name_for(repo.full_name)
        assert svc.get_index(name).commit is not None
        assert svc.sync_repository(repo.full_name) is False
        (origin / "src" / "extra.py").write_text("def extra_feature(): pass\n")
        _git(["add", "-A"], origin)
        _git(["commit", "-m", "feature"], origin)
        assert svc.handle_webhook(WebhookEvent(event_type="push", repository=repo)) is True
        hits = svc.search("extra feature", top_k=5)
        assert any("extra.py" in h["path"] for h in hits)
        ev = WebhookEvent(event_type="pull_request", repository=repo)
        assert svc.handle_webhook(ev) is False


class TestRecomputeMode:
    """Token table on disk, no [n, d] float matrix, exact distances
    recomputed through the encoder."""

    @pytest.fixture
    def rsvc(self, tmp_path):
        enc = TextEncoder.from_preset("tiny-test", seed=0, device="cpu")
        cfg = IndexerConfig(base_path=str(tmp_path / "islands"),
                            embedding=EmbeddingConfig(kind="encoder", recompute=True))
        return IndexerService(cfg, embedder=enc, device="cpu"), enc

    def test_no_float_matrix_on_disk(self, rsvc, tmp_path):
        svc, _ = rsvc
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        info = svc.index_local_path(src, "proj")
        assert info.mode == "recompute"
        d = Path(svc.config.indexes_path) / "proj"
        assert (d / "tokens.npz").exists()
        assert not (d / "embeddings.npy").exists()
        emb_bytes = info.num_chunks * info.dimension * 4
        for f in d.iterdir():
            if f.name in ("tokens.npz", "chunks.json"):
                continue
            assert f.stat().st_size < max(emb_bytes, 4096) or f.name == "index.leann"

    def test_recompute_search_self_retrieval(self, rsvc, tmp_path):
        svc, _ = rsvc
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        stored = svc.indexes["proj"]
        hits = 0
        for c in stored.chunks:
            res = svc.search(c.text, top_k=3)
            hits += (c.path, c.start_line) in [(r["path"], r["start_line"]) for r in res]
        assert hits / len(stored.chunks) >= 0.9

    def test_reload_uses_token_table(self, rsvc, tmp_path):
        svc, enc = rsvc
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        before = svc.search("beam search query function", top_k=3)
        svc2 = IndexerService(svc.config, embedder=enc, device="cpu")
        after = svc2.search("beam search query function", top_k=3)
        assert after == before
        assert isinstance(svc2.indexes["proj"].provider, EncoderEmbeddingProvider)

    def test_centred_provider_reloads_its_center(self, rsvc, tmp_path):
        svc, enc = rsvc
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        stored = svc.indexes["proj"]
        stored.provider = stored.provider.with_center()
        svc._persist_index(stored)
        toks = np.load(Path(svc.config.indexes_path) / "proj" / "tokens.npz")
        np.testing.assert_array_equal(toks["center"], stored.provider.center.numpy())
        svc2 = IndexerService(svc.config, embedder=enc, device="cpu")
        svc2.search("beam search", top_k=1)
        np.testing.assert_array_equal(svc2.indexes["proj"].provider.center.numpy(),
                                      toks["center"])

    def test_recompute_requires_encoder(self, tmp_path):
        cfg = IndexerConfig(base_path=str(tmp_path / "islands"),
                            embedding=EmbeddingConfig(kind="hash", recompute=True))
        svc = IndexerService(cfg, device="cpu")
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        with pytest.raises(IndexingFailed):
            svc.index_local_path(src, "proj")


class TestWorkspaces:
    def test_crud_and_scoped_search(self, svc, tmp_path):
        for name, text in (("alpha", "alpha retrieval engine code"),
                           ("beta", "beta database migration sql")):
            src = tmp_path / name
            make_tree(src, {f"{name}.py": f"# {text}\n" + "\n".join(
                f"def {name}_{i}(): pass" for i in range(3))})
            svc.index_local_path(src, name, repository=f"org/{name}")
        svc.create_workspace("ws", "test workspace")
        svc.add_repo_to_workspace("ws", "org/alpha")
        assert svc.get_workspace("ws")["repositories"] == ["org/alpha"]
        assert svc.get_workspace_index_names("ws") == ["org_alpha"]
        hits = svc.search("retrieval engine", workspace="ws")
        assert all(h["index"] == "org_alpha" for h in hits)
        assert [w["name"] for w in svc.list_workspaces()] == ["ws"]
        svc.remove_repo_from_workspace("ws", "org/alpha")
        assert svc.get_workspace("ws")["repositories"] == []
        svc.delete_workspace("ws")
        with pytest.raises(WorkspaceNotFound):
            svc.get_workspace("ws")


class TestWatcher:
    def test_extract_repo_path(self, tmp_path):
        f = tmp_path / "github" / "owner" / "repo" / "src" / "a.py"
        assert extract_repo_path(tmp_path, f) == "github/owner/repo"
        assert extract_repo_path(tmp_path, tmp_path / "too" / "short") is None
        assert extract_repo_path(tmp_path, Path("/elsewhere/x/y/z")) is None

    def test_debounce(self, tmp_path):
        fired = []
        root = tmp_path / "repos"
        make_tree(root, {"gh/o/r/src/a.py": "x = 1\n"})
        w = IndexWatcher(root, fired.append, debounce_seconds=10.0)
        w._mtimes = w._scan()
        t0 = time.monotonic()
        (root / "gh/o/r/src/a.py").write_text("x = 2\n")
        assert w.poll_once(now=t0) == []
        assert w.poll_once(now=t0 + 5.0) == []
        assert w.poll_once(now=t0 + 11.0) == ["gh/o/r"]
        assert fired == ["gh/o/r"]
        assert w.poll_once(now=t0 + 30.0) == []

    def test_git_dir_ignored(self, tmp_path):
        fired = []
        root = tmp_path / "repos"
        make_tree(root, {"gh/o/r/.git/HEAD": "ref: x\n", "gh/o/r/a.py": "x\n"})
        w = IndexWatcher(root, fired.append, debounce_seconds=0.0)
        w._mtimes = w._scan()
        (root / "gh/o/r/.git/HEAD").write_text("ref: y\n")
        assert w.poll_once() == []

    def test_start_stop(self, tmp_path):
        root = tmp_path / "repos"
        root.mkdir()
        w = IndexWatcher(root, lambda _: None, debounce_seconds=0.0, poll_interval=0.01)
        w.start()
        thread = w._thread
        w.stop()
        assert not thread.is_alive()


class TestReviewRegressions:
    def test_repos_persist_across_restart(self, svc, origin):
        repo = Repository.new("local", "owner", "sample", str(origin))
        svc.manager.clone_repository(repo)
        svc.index_repository(repo)
        svc2 = IndexerService(IndexerConfig(base_path=svc.config.base_path), device="cpu")
        assert "owner/sample" in svc2.repos
        assert svc2.sync_repository("owner/sample") in (True, False)

    def test_reload_uses_embedding_cache(self, svc, tmp_path):
        src = tmp_path / "proj"
        make_tree(src, SAMPLE)
        svc.index_local_path(src, "proj")
        assert (Path(svc.config.base_path) / "indexes" / "proj" / "embeddings.npy").exists()
        svc2 = IndexerService(IndexerConfig(base_path=svc.config.base_path), device="cpu")
        calls = []
        orig = svc2.embed_texts
        svc2.embed_texts = lambda texts: (calls.append(len(texts)), orig(texts))[1]
        assert svc2.search("hello world", top_k=3)
        assert calls == [1]

    def test_path_overrides(self, tmp_path):
        cfg = IndexerConfig(
            base_path=str(tmp_path / "base"),
            repos_path_override=str(tmp_path / "elsewhere_repos"),
            indexes_path_override=str(tmp_path / "elsewhere_idx"),
        )
        IndexerService(cfg, device="cpu")
        assert (tmp_path / "elsewhere_repos").exists()
        assert (tmp_path / "elsewhere_idx").exists()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_either_service_loads_the_others_index(writer, tmp_path):
    """The hash-embedder service of one package indexes a tree; the other
    package's service, on the same base path, lists it and returns the same
    hits (paths, lines and scores) for the same queries."""
    src = tmp_path / "proj"
    make_tree(src, SAMPLE)
    base = str(tmp_path / "islands")
    if writer == "reference":
        first = JIndexerService(JIndexerConfig(base_path=base, use_native_loader=False))
    else:
        first = IndexerService(IndexerConfig(base_path=base, use_native_loader=False),
                               device="cpu")
    first.index_local_path(src, "proj")
    reader = (IndexerService(IndexerConfig(base_path=base), device="cpu")
              if writer == "reference" else JIndexerService(JIndexerConfig(base_path=base)))
    assert [i.to_dict() for i in reader.list_indexes()] == [
        i.to_dict() for i in first.list_indexes()]
    for query in ("beam search query function", "distance between vectors", "hello world"):
        want, got = first.search(query, top_k=5), reader.search(query, top_k=5)
        assert [(h["index"], h["path"], h["start_line"], h["end_line"]) for h in got] == [
            (h["index"], h["path"], h["start_line"], h["end_line"]) for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   atol=1e-5, rtol=1e-6)
