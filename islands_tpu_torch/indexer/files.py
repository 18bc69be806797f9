"""File collection and chunking: config 1's host feed.

Port of islands_tpu/indexer/files.py. Collection skips hidden entries,
`node_modules` and `target`, keeps files whose extension is in the list and
reads them as UTF-8 (files that fail to decode are skipped). Chunking makes
line-aware windows with a character budget and an overlap, so one file
yields several retrieval-sized chunks and each chunk's (path, line range,
text) is exact.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

DEFAULT_EXTENSIONS = (
    "py", "js", "ts", "jsx", "tsx", "java", "go", "rs", "c", "cpp", "h",
    "hpp", "cs", "rb", "php", "swift", "kt", "scala", "sql", "sh", "bash",
    "yaml", "yml", "json", "toml", "md", "rst", "txt",
)

SKIP_DIRS = {"node_modules", "target"}


@dataclasses.dataclass
class Chunk:
    """One retrieval unit: a contiguous line range of a file."""

    path: str  # repo-relative
    start_line: int  # 1-based, inclusive
    end_line: int  # inclusive
    text: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Chunk":
        return Chunk(**d)


def matches_extension(path: Path, extensions=DEFAULT_EXTENSIONS) -> bool:
    """Whether the path's extension is in the list."""
    ext = path.suffix.removeprefix(".")
    return ext in extensions


def iter_source_files(
    root: str | Path, extensions=DEFAULT_EXTENSIONS
) -> Iterator[Path]:
    """Walk `root` skipping hidden/node_modules/target dirs and non-matching
    files, in sorted (deterministic) order."""
    root = Path(root)

    def walk(d: Path) -> Iterator[Path]:
        try:
            entries = sorted(d.iterdir())
        except OSError:
            return
        for entry in entries:
            name = entry.name
            if name.startswith(".") or name in SKIP_DIRS:
                continue
            if entry.is_dir() and not entry.is_symlink():
                yield from walk(entry)
            elif entry.is_file() and matches_extension(entry, extensions):
                yield entry

    yield from walk(root)


def collect_files(
    root: str | Path, extensions=DEFAULT_EXTENSIONS
) -> list[tuple[str, str]]:
    """[(relative_path, content)] for all indexable files; non-UTF-8 files
    are skipped."""
    root = Path(root)
    out = []
    for p in iter_source_files(root, extensions):
        try:
            content = p.read_text(encoding="utf-8")
        except (UnicodeDecodeError, OSError):
            continue
        out.append((str(p.relative_to(root)), content))
    return out


def chunk_text(
    path: str,
    content: str,
    chunk_size: int = 512,
    chunk_overlap: int = 64,
) -> list[Chunk]:
    """Split file content into line-aware chunks of ~chunk_size characters
    with ~chunk_overlap characters of trailing context carried into the next
    chunk. Never splits inside a line; a single overlong line becomes its own
    chunk."""
    if not content.strip():
        return []
    lines = content.splitlines()
    chunks: list[Chunk] = []
    start = 0
    n = len(lines)
    while start < n:
        size = 0
        end = start
        while end < n and (size == 0 or size + len(lines[end]) + 1 <= chunk_size):
            size += len(lines[end]) + 1
            end += 1
        text = "\n".join(lines[start:end])
        if text.strip():
            chunks.append(
                Chunk(path=path, start_line=start + 1, end_line=end, text=text)
            )
        if end >= n:
            break
        # Overlap: back up whole lines worth ~chunk_overlap chars.
        back = end
        over = 0
        while back > start + 1 and over + len(lines[back - 1]) + 1 <= chunk_overlap:
            over += len(lines[back - 1]) + 1
            back -= 1
        start = max(back, start + 1)
    return chunks


def chunk_files(
    files: list[tuple[str, str]],
    chunk_size: int = 512,
    chunk_overlap: int = 64,
) -> list[Chunk]:
    out: list[Chunk] = []
    for path, content in files:
        out.extend(chunk_text(path, content, chunk_size, chunk_overlap))
    return out
