"""ctypes binding for the native C++ data loader (dataloader.cpp beside
this module).

Port of islands_tpu/indexer/native.py. The shared library is compiled with
g++ at first use into build/islands_tpu_torch/ under the repository root
(the source's hash names the file), beside the CUDA libraries. Without a
toolchain the callers fall back to the Python walker and chunker of
files.py, whose output the native loader reproduces exactly: its source is
the repository's native/dataloader.cpp with chunk budgets counted in
characters, not bytes (see the source's header).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
from pathlib import Path

from islands_tpu_torch.indexer.files import Chunk

logger = logging.getLogger("islands_tpu_torch.native")

_SRC = Path(__file__).resolve().with_name("dataloader.cpp")
BUILD_DIR = _SRC.parent.parent.parent / "build" / "islands_tpu_torch"
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdataloader-{tag}.so"


def _build_library() -> Path | None:
    if not _SRC.exists():
        return None
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native dataloader build failed (%s); using the Python path", e)
        return None
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL | None:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    so = _build_library()
    if so is None:
        _LIB_FAILED = True
        return None
    lib = ctypes.CDLL(str(so))
    lib.it_collect_chunks.restype = ctypes.c_int
    lib.it_collect_chunks.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.it_free.restype = None
    lib.it_free.argtypes = [ctypes.c_char_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def collect_chunks_native(
    root: str | Path,
    extensions,
    chunk_size: int = 512,
    chunk_overlap: int = 64,
    n_threads: int = 0,
) -> list[Chunk] | None:
    """Walk + read + chunk in native threads. Returns None when the native
    library is unavailable or fails (callers fall back to the Python path)."""
    lib = _load()
    if lib is None:
        return None
    out_buf = ctypes.c_char_p()
    out_len = ctypes.c_uint64()
    rc = lib.it_collect_chunks(
        str(root).encode(), ",".join(extensions).encode(),
        chunk_size, chunk_overlap, n_threads,
        ctypes.byref(out_buf), ctypes.byref(out_len),
    )
    if rc != 0:
        logger.warning("native loader returned %d; falling back", rc)
        return None
    try:
        raw = ctypes.string_at(out_buf, out_len.value)
    finally:
        lib.it_free(out_buf)
    return _parse(raw)


def _parse(raw: bytes) -> list[Chunk]:
    (num,) = struct.unpack_from("<Q", raw, 0)
    off = 8
    chunks: list[Chunk] = []
    for _ in range(num):
        (plen,) = struct.unpack_from("<I", raw, off)
        off += 4
        path = raw[off : off + plen].decode()
        off += plen
        start, end, tlen = struct.unpack_from("<III", raw, off)
        off += 12
        text = raw[off : off + tlen].decode()
        off += tlen
        chunks.append(Chunk(path=path, start_line=start, end_line=end, text=text))
    return chunks
