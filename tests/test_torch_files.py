"""indexer/files.py and indexer/native.py of the port (config 1's feed)
against the JAX package's: the same files and chunks on tmp trees, and the
native loader's exact parity with the Python chunker (mirrors
tests/test_native.py; those cases skip without a C++ toolchain)."""

import dataclasses

import pytest

from islands_tpu.indexer import files as jfiles
from islands_tpu.indexer import native as jnative
from islands_tpu_torch.indexer import files as tfiles
from islands_tpu_torch.indexer import native as tnative

from tests.test_indexer import SAMPLE, make_tree

EXTS = ("py", "rs", "md")
UNICODE = "\n".join(f"# línea {i} — über café 日本 {'x' * (i % 40)}"
                    for i in range(120))


def _tree(root):
    make_tree(root, SAMPLE)
    (root / "src" / "big.py").write_text(
        "\n".join(f"def function_{i}(): return {i}" for i in range(200)))
    (root / "src" / "unicode.md").write_text(UNICODE)
    (root / "src" / "crlf.py").write_bytes(b"a = 1\r\nb = 2\r\n" * 40)
    (root / "latin1.py").write_bytes("café = 1\n".encode("latin-1"))
    return root


def _rows(chunks):
    return [dataclasses.astuple(c) for c in chunks]


@pytest.mark.parametrize("exts", [EXTS, ("md",), tfiles.DEFAULT_EXTENSIONS])
def test_collect_files_equal(tmp_path, exts):
    _tree(tmp_path)
    got = tfiles.collect_files(tmp_path, exts)
    assert got == jfiles.collect_files(tmp_path, exts)
    paths = [p for p, _ in got]
    assert "latin1.py" not in paths
    assert not any(p.startswith(".hidden") or "node_modules" in p or p.startswith("target")
                   for p in paths)
    assert [str(p) for p in tfiles.iter_source_files(tmp_path, exts)] == \
        [str(p) for p in jfiles.iter_source_files(tmp_path, exts)]


@pytest.mark.parametrize("size,overlap", [(512, 64), (256, 48), (64, 0), (20, 30)])
def test_chunks_equal(tmp_path, size, overlap):
    _tree(tmp_path)
    files = tfiles.collect_files(tmp_path, EXTS)
    got = tfiles.chunk_files(files, size, overlap)
    assert _rows(got) == _rows(jfiles.chunk_files(files, size, overlap))
    assert len(got) > len(files)


def test_chunk_text_edges():
    for content in ("", "  \n \n", "line1\nline2\n", "x" * 2000, "a\n" + "y" * 700 + "\nb"):
        assert _rows(tfiles.chunk_text("a.py", content, 512, 64)) == \
            _rows(jfiles.chunk_text("a.py", content, 512, 64))
    c = tfiles.Chunk("p", 1, 2, "t")
    assert tfiles.Chunk.from_dict(c.to_dict()) == c


@pytest.fixture
def native():
    if not tnative.native_available():
        pytest.skip("no C++ toolchain for the native loader")
    return tnative


@pytest.mark.parametrize("size,overlap", [(512, 64), (256, 48)])
def test_native_parity_with_python_chunker(tmp_path, native, size, overlap):
    _tree(tmp_path)
    py_chunks = tfiles.chunk_files(tfiles.collect_files(tmp_path, EXTS), size, overlap)
    nat_chunks = native.collect_chunks_native(tmp_path, EXTS, size, overlap)
    assert _rows(nat_chunks) == _rows(py_chunks)


def test_reference_native_loader_counts_bytes(tmp_path, native):
    """The repository's native/dataloader.cpp budgets chunks in bytes, so on
    non-ASCII lines its chunks differ from files.chunk_text's; the port's
    copy counts characters and agrees."""
    if not jnative.native_available():
        pytest.skip("no C++ toolchain for the reference's native loader")
    (tmp_path / "u.md").write_text(UNICODE)
    want = _rows(jfiles.chunk_files(jfiles.collect_files(tmp_path, ("md",)), 256, 48))
    assert _rows(jnative.collect_chunks_native(tmp_path, ("md",), 256, 48)) != want
    assert _rows(native.collect_chunks_native(tmp_path, ("md",), 256, 48)) == want


def test_native_skips_binary_and_hidden(tmp_path, native):
    _tree(tmp_path)
    (tmp_path / "bin.py").write_bytes(b"\x00\x01binary\x00")
    paths = {c.path for c in native.collect_chunks_native(tmp_path, EXTS, 512, 64)}
    assert "bin.py" not in paths and "latin1.py" not in paths
    assert not any(p.startswith(".hidden") or "node_modules" in p for p in paths)


def test_native_empty_and_missing_dir(tmp_path, native):
    assert native.collect_chunks_native(tmp_path, ("py",), 512, 64) == []
    assert native.collect_chunks_native(tmp_path / "ghost", ("py",), 512, 64) is None


def test_native_builds_under_the_repository(native):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "islands_tpu_torch")


def test_no_toolchain_falls_back(monkeypatch, tmp_path):
    """Without g++ the library is not built and callers get None (then the
    Python path)."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_FAILED", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not tnative.native_available()
    assert tnative.collect_chunks_native(tmp_path, ("py",), 512, 64) is None
