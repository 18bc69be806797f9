"""On-disk index storage: a tagged-chunk container with CSR, PQ and sketch
payloads.

Port of islands_tpu/core/storage.py, byte for byte: a file written by either
package loads in the other (docs/format.md). Each chunk is a 4-byte ASCII
tag, a u64 little-endian length and the payload:
- META: IndexMetadata as JSON, the index's config under extra["config"]
  (`dataclasses.asdict` order, enums as their `.value` strings);
- GRPH: the graph as true CSR (`LEGR` header, u64 row offsets, i32 edges,
  i32 levels), 4 bytes per edge;
- PQCB / PQCD: the PQ codebook (f32) and codes (u8 up to 256 centroids, u16
  above; the port holds codes above 256 centroids as int32 in memory);
- SKCH: the sketch's scale, projection and per-node sketches (the inline
  neighbour blocks are rebuilt from them and the graph at load);
- for HNSW: GRPH of layer 0, EMBS (the stored prepped vectors) and one HLnn
  chunk per upper layer.

`load_index` and `load_hnsw` put the index on CUDA unless `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
from pathlib import Path
from typing import BinaryIO, Protocol

import numpy as np
import torch

from islands_tpu_torch.core.config import (
    DistanceMetric,
    HnswConfig,
    LeannConfig,
    PQConfig,
    PruningStrategy,
)
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops.proj import PACK, SketchIndex

FORMAT_VERSION = 1

_METRIC_CODES = {"euclidean": 0, "cosine": 1, "dotproduct": 2, "manhattan": 3}
_METRIC_NAMES = {v: k for k, v in _METRIC_CODES.items()}


class StorageError(IOError):
    """Corrupt or unreadable index file."""


# ---------------------------------------------------------------------------
# Metadata and key-value backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IndexMetadata:
    """The META chunk."""

    version: int = FORMAT_VERSION
    num_vectors: int = 0
    dimension: int = 0
    metric: str = "cosine"
    created_at: float = 0.0
    updated_at: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def new(num_vectors: int, dimension: int, metric: str = "cosine") -> "IndexMetadata":
        now = time.time()
        return IndexMetadata(num_vectors=num_vectors, dimension=dimension, metric=metric,
                             created_at=now, updated_at=now)

    def touch(self) -> None:
        self.updated_at = time.time()

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @staticmethod
    def from_json(data: bytes) -> "IndexMetadata":
        return IndexMetadata(**json.loads(data))


class StorageBackend(Protocol):
    """Key-value blob storage."""

    def save(self, key: str, data: bytes) -> None: ...
    def load(self, key: str) -> bytes: ...
    def exists(self, key: str) -> bool: ...
    def delete(self, key: str) -> None: ...


class FileSystemStorage:
    """Directory-backed storage; keys may not leave the root."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if self.root.resolve() not in p.parents and p != self.root.resolve():
            raise StorageError(f"key escapes storage root: {key}")
        return p

    def save(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)  # atomic on POSIX

    def load(self, key: str) -> bytes:
        p = self._path(key)
        if not p.exists():
            raise StorageError(f"key not found: {key}")
        return p.read_bytes()

    def exists(self, key: str) -> bool:
        return self._path(key).exists()

    def delete(self, key: str) -> None:
        p = self._path(key)
        if p.exists():
            p.unlink()


# ---------------------------------------------------------------------------
# Tagged-chunk container
# ---------------------------------------------------------------------------


class IndexWriter:
    """Chunked writer: tag(4) + u64-LE length + payload per chunk."""

    def __init__(self, stream: BinaryIO):
        self._stream = stream

    def write_chunk(self, tag: bytes, data: bytes) -> None:
        if len(tag) != 4:
            raise StorageError(f"tag must be 4 bytes, got {tag!r}")
        self._stream.write(tag)
        self._stream.write(struct.pack("<Q", len(data)))
        self._stream.write(data)

    def write_metadata(self, metadata: IndexMetadata) -> None:
        self.write_chunk(b"META", metadata.to_json())


class IndexReader:
    """Chunked reader; `read_all` returns {tag: payload} in file order."""

    def __init__(self, stream: BinaryIO):
        self._stream = stream

    def read_chunk(self) -> tuple[bytes, bytes] | None:
        tag = self._stream.read(4)
        if len(tag) == 0:
            return None
        if len(tag) != 4:
            raise StorageError("truncated chunk tag")
        len_bytes = self._stream.read(8)
        if len(len_bytes) != 8:
            raise StorageError("truncated chunk length")
        (length,) = struct.unpack("<Q", len_bytes)
        data = self._stream.read(length)
        if len(data) != length:
            raise StorageError(f"truncated chunk payload for {tag!r}")
        return tag, data

    def read_all(self) -> dict[bytes, bytes]:
        chunks: dict[bytes, bytes] = {}
        while (c := self.read_chunk()) is not None:
            chunks[c[0]] = c[1]
        return chunks

    def read_metadata(self) -> IndexMetadata:
        c = self.read_chunk()
        if c is None or c[0] != b"META":
            raise StorageError("expected META chunk")
        return IndexMetadata.from_json(c[1])


# ---------------------------------------------------------------------------
# Payload codecs
# ---------------------------------------------------------------------------

# magic, version, n, max_degree, entry, max_level, metric, dim
_GRPH_HEADER = struct.Struct("<4sIQIiiBI")


def encode_graph(graph: CsrGraph, metric: str, dimension: int) -> bytes:
    """CsrGraph -> header + row offsets u64 + edges i32 + levels i32."""
    offsets, flat, levels = graph.to_csr_arrays()
    buf = io.BytesIO()
    buf.write(_GRPH_HEADER.pack(b"LEGR", FORMAT_VERSION, graph.num_nodes, graph.max_degree,
                                int(graph.entry_point), int(graph.max_level),
                                _METRIC_CODES.get(metric, 1), dimension))
    buf.write(np.ascontiguousarray(offsets, dtype="<u8").tobytes())
    buf.write(np.ascontiguousarray(flat, dtype="<i4").tobytes())
    buf.write(np.ascontiguousarray(levels, dtype="<i4").tobytes())
    return buf.getvalue()


def decode_graph(data: bytes, device=None) -> tuple[CsrGraph, str, int]:
    """-> (graph on `device`, metric name, dimension)."""
    magic, ver, n, max_deg, entry, max_level, metric_code, dim = _GRPH_HEADER.unpack_from(data)
    if magic != b"LEGR":
        raise StorageError(f"bad graph magic {magic!r}")
    if ver != FORMAT_VERSION:
        raise StorageError(f"unsupported graph version {ver}")
    off = _GRPH_HEADER.size
    offsets = np.frombuffer(data, dtype="<u8", count=n + 1, offset=off).astype(np.int64)
    off += (n + 1) * 8
    num_edges = int(offsets[-1]) if n > 0 else 0
    flat = np.frombuffer(data, dtype="<i4", count=num_edges, offset=off)
    off += num_edges * 4
    levels = np.frombuffer(data, dtype="<i4", count=n, offset=off).copy()
    graph = CsrGraph.from_csr_arrays(offsets, flat, levels, entry_point=entry,
                                     max_level=max_level, max_degree=max_deg, device=device)
    return graph, _METRIC_NAMES.get(metric_code, "cosine"), dim


_PQCB_HEADER = struct.Struct("<4sIIIH")  # magic, version, num_sq, num_centroids, sub_dim


def encode_pq_codebook(centroids: np.ndarray) -> bytes:
    """[S, K, sub_dim] f32 -> "PQCB" payload."""
    s, k, sd = centroids.shape
    buf = io.BytesIO()
    buf.write(_PQCB_HEADER.pack(b"PQCB", FORMAT_VERSION, s, k, sd))
    buf.write(np.ascontiguousarray(centroids, dtype="<f4").tobytes())
    return buf.getvalue()


def decode_pq_codebook(data: bytes) -> np.ndarray:
    magic, ver, s, k, sd = _PQCB_HEADER.unpack_from(data)
    if magic != b"PQCB":
        raise StorageError(f"bad codebook magic {magic!r}")
    arr = np.frombuffer(data, dtype="<f4", count=s * k * sd, offset=_PQCB_HEADER.size)
    return arr.reshape(s, k, sd).copy()


_PQCD_HEADER = struct.Struct("<4sIQIB")  # magic, version, num_vectors, num_sq, code_bytes


def encode_pq_codes(codes: np.ndarray, num_centroids: int | None = None) -> bytes:
    """[n, S] codes -> "PQCD" payload, packed row-major. The code width
    follows the codebook: 1 byte up to 256 centroids, 2 above (the port
    keeps such codes as int32 in memory; the file never holds 4-byte
    codes). Without `num_centroids` the width is the array's: u8 or u16."""
    n, s = codes.shape
    if num_centroids is not None:
        code_bytes = 1 if num_centroids <= 256 else 2
    else:
        code_bytes = 1 if codes.dtype.itemsize == 1 else 2
    buf = io.BytesIO()
    buf.write(_PQCD_HEADER.pack(b"PQCD", FORMAT_VERSION, n, s, code_bytes))
    buf.write(np.ascontiguousarray(codes, dtype="<u1" if code_bytes == 1 else "<u2").tobytes())
    return buf.getvalue()


def decode_pq_codes(data: bytes) -> np.ndarray:
    """-> [n, S] uint8 or uint16 codes, as stored."""
    magic, ver, n, s, code_bytes = _PQCD_HEADER.unpack_from(data)
    if magic != b"PQCD":
        raise StorageError(f"bad codes magic {magic!r}")
    dt = "<u1" if code_bytes == 1 else "<u2"
    arr = np.frombuffer(data, dtype=dt, count=n * s, offset=_PQCD_HEADER.size)
    return arr.reshape(n, s).copy()


_SKCH_HEADER = struct.Struct("<4sIQII")  # magic, version, n, dim, proj_dims


def encode_sketch(sketch: SketchIndex) -> bytes:
    """SketchIndex -> "SKCH" payload: scale f32 + W f32 [dim, P] + per-node
    packed sketches i32 [n, P/4]; P bytes per vector on disk."""
    w = sketch.w.detach().cpu().numpy().astype(np.float32)
    node = sketch.node_sketch.detach().cpu().numpy().astype(np.int32)
    dim, p = w.shape
    buf = io.BytesIO()
    buf.write(_SKCH_HEADER.pack(b"SKCH", FORMAT_VERSION, node.shape[0], dim, p))
    buf.write(struct.pack("<f", float(sketch.scale)))
    buf.write(np.ascontiguousarray(w, dtype="<f4").tobytes())
    buf.write(np.ascontiguousarray(node, dtype="<i4").tobytes())
    return buf.getvalue()


def decode_sketch(data: bytes, neighbors: torch.Tensor) -> SketchIndex:
    """-> SketchIndex on `neighbors`' device, with the inline neighbour
    blocks rebuilt row-aligned with `neighbors` [n, m]."""
    magic, ver, n, dim, p = _SKCH_HEADER.unpack_from(data)
    if magic != b"SKCH":
        raise StorageError(f"bad sketch magic {magic!r}")
    if ver != FORMAT_VERSION:
        raise StorageError(f"unsupported sketch format version {ver}")
    off = _SKCH_HEADER.size
    (scale,) = struct.unpack_from("<f", data, off)
    off += 4
    w = np.frombuffer(data, dtype="<f4", count=dim * p, offset=off).reshape(dim, p)
    off += dim * p * 4
    node = np.frombuffer(data, dtype="<i4", count=n * (p // PACK), offset=off)
    dev = neighbors.device
    node_t = to_device(node.reshape(n, p // PACK), dev, torch.int32)
    nbr = node_t[torch.clamp(neighbors.long(), 0, max(n - 1, 0))].reshape(neighbors.shape[0], -1)
    return SketchIndex(w=to_device(w, dev, torch.float32),
                       scale=torch.tensor(scale, dtype=torch.float32, device=dev),
                       node_sketch=node_t, nbr_sketch=nbr)


def config_to_dict(config) -> dict:
    """A config as the header JSON holds it: its fields in order, enums as
    their values."""
    cfg = dataclasses.asdict(config)
    for key in ("metric", "pruning_strategy"):
        if key in cfg:
            cfg[key] = getattr(cfg[key], "value", str(cfg[key]))
    return cfg


def _config_from_meta(meta: IndexMetadata, cls):
    """The config of META; keys unknown to `cls` are ignored, as the
    reference ignores keys of older format revisions."""
    return config_from_dict(meta.extra.get("config", {}), cls)


def config_from_dict(cfg: dict, cls):
    """A `cls` config from its saved dict (`config_to_dict`'s), ignoring
    unknown keys; the default config when `cfg` is empty."""
    cfg = dict(cfg)
    if not cfg:
        return cls()
    cfg["metric"] = DistanceMetric(cfg.get("metric", "cosine"))
    if cls is LeannConfig:
        cfg["pruning_strategy"] = PruningStrategy(cfg.get("pruning_strategy", "global"))
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in cfg.items() if k in known})


def write_atomic(path: Path, data: bytes) -> int:
    """Write `data` through a .tmp file renamed over `path`; -> its size."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(path)
    return len(data)


# ---------------------------------------------------------------------------
# LeannIndex save/load
# ---------------------------------------------------------------------------


def save_index(index, path: str | Path, persist_sketch: bool = True) -> int:
    """Serialize a LeannIndex (graph, optional PQ and sketch, config) to
    `path`; returns the bytes written.

    `persist_sketch=False` is storage-parity mode: no SKCH chunk, the
    reference's CSR-only layout. The port re-derives the sketch at load from
    stored embeddings and the loaded graph with
    `ops.proj.build_sketch_index(x_prepped, graph.neighbors, proj_dims,
    seed)`, the build's own recipe, so for an index built here it is the
    construction sketch bit for bit. For a file written by the JAX package
    that recipe gives another projection (torch cannot redo jax.random's
    draw): a valid sketch, but not the reference's."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    graph = index.graph
    if graph is None:
        raise StorageError("index is not built")
    cfg = config_to_dict(index.config)
    metric = cfg["metric"]
    meta = IndexMetadata.new(graph.num_nodes, index.dimension or 0, metric)
    meta.extra["config"] = cfg

    buf = io.BytesIO()
    w = IndexWriter(buf)
    w.write_metadata(meta)
    w.write_chunk(b"GRPH", encode_graph(graph, metric, index.dimension or 0))
    if index.pq is not None and index.pq_codes is not None:
        centroids = index.pq.codebook.centroids.detach().cpu().numpy()
        w.write_chunk(b"PQCB", encode_pq_codebook(centroids))
        w.write_chunk(b"PQCD", encode_pq_codes(index.pq_codes.cpu().numpy(),
                                               centroids.shape[1]))
    if persist_sketch and index.sketch is not None:
        w.write_chunk(b"SKCH", encode_sketch(index.sketch))
    return write_atomic(path, buf.getvalue())


def load_index(path: str | Path, device=None):
    """Load a LeannIndex saved by `save_index` (by either package)."""
    from islands_tpu_torch.core.leann import LeannIndex
    from islands_tpu_torch.core.pq import PQCodebook, ProductQuantizer

    dev = resolve_device(device)
    chunks = IndexReader(io.BytesIO(Path(path).read_bytes())).read_all()
    if b"META" not in chunks or b"GRPH" not in chunks:
        raise StorageError("missing META/GRPH chunk")
    meta = IndexMetadata.from_json(chunks[b"META"])
    index = LeannIndex(_config_from_meta(meta, LeannConfig), device=dev)
    graph, _, dim = decode_graph(chunks[b"GRPH"], dev)
    index.graph = graph
    index.dimension = dim or meta.dimension or None
    if b"PQCB" in chunks and b"PQCD" in chunks:
        centroids = decode_pq_codebook(chunks[b"PQCB"])
        s, k, sd = centroids.shape
        pq = ProductQuantizer(PQConfig(num_subquantizers=s, num_centroids=k), device=dev)
        pq.codebook = PQCodebook(centroids=to_device(centroids, dev, torch.float32))
        pq._dimension = s * sd
        index.pq = pq
        index.pq_codes = to_device(decode_pq_codes(chunks[b"PQCD"]).astype(np.int64), dev,
                                   pq.code_dtype)
    if b"SKCH" in chunks:
        index.sketch = decode_sketch(chunks[b"SKCH"], graph.neighbors)
        index._init_routing()
    return index


# ---------------------------------------------------------------------------
# HnswIndex save/load: one GRPH chunk for layer 0 plus the stored vectors
# and the upper layers (HNSW keeps full embeddings, unlike LEANN)
# ---------------------------------------------------------------------------

_HL_HEADER = struct.Struct("<QI")  # n_l, m_l


def save_hnsw(index, path: str | Path) -> int:
    """Serialize an HnswIndex (embeddings, layer 0, upper layers, config);
    returns the bytes written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if index.layer0 is None:
        raise StorageError("index is not built")
    cfg = config_to_dict(index.config)
    metric = cfg["metric"]
    meta = IndexMetadata.new(index.num_nodes, index.dimension or 0, metric)
    meta.extra["config"] = cfg
    meta.extra["num_upper_layers"] = len(index.layers)

    buf = io.BytesIO()
    w = IndexWriter(buf)
    w.write_metadata(meta)
    # Layer 0 is built with all-zero levels; it is written with the index's
    # levels and entry so the loaded graph carries the hierarchy.
    g0 = CsrGraph(neighbors=index.layer0.neighbors, degrees=index.layer0.degrees,
                  levels=torch.as_tensor(index.levels, dtype=torch.int32),
                  entry_point=int(index.entry_point), max_level=int(index.max_level))
    w.write_chunk(b"GRPH", encode_graph(g0, metric, index.dimension or 0))
    w.write_chunk(b"EMBS", np.ascontiguousarray(index.x.cpu().numpy(), dtype="<f4").tobytes())
    for li, layer in enumerate(index.layers):
        ids = np.asarray(layer.ids, dtype="<i4")
        nbrs = layer.neighbors.cpu().numpy().astype("<i4")
        w.write_chunk(b"HL%02d" % li, _HL_HEADER.pack(ids.shape[0], nbrs.shape[1])
                      + ids.tobytes() + np.ascontiguousarray(nbrs).tobytes())
    return write_atomic(path, buf.getvalue())


def load_hnsw(path: str | Path, device=None):
    """Load an HnswIndex saved by `save_hnsw` (by either package)."""
    from islands_tpu_torch.core.hnsw import HnswIndex, HnswLayer

    dev = resolve_device(device)
    chunks = IndexReader(io.BytesIO(Path(path).read_bytes())).read_all()
    if b"META" not in chunks or b"GRPH" not in chunks or b"EMBS" not in chunks:
        raise StorageError("missing META/GRPH/EMBS chunk")
    meta = IndexMetadata.from_json(chunks[b"META"])
    index = HnswIndex(_config_from_meta(meta, HnswConfig), device=dev)
    graph, _, dim = decode_graph(chunks[b"GRPH"], dev)
    n = graph.num_nodes
    x = np.frombuffer(chunks[b"EMBS"], dtype="<f4").reshape(n, dim)
    index.x = to_device(x, dev, torch.float32)
    index.dimension = dim
    index.layer0 = graph
    index.levels = graph.levels.cpu().numpy()
    index.max_level = int(graph.max_level)
    index.entry_point = int(graph.entry_point)
    index.layers = []
    for li in range(int(meta.extra.get("num_upper_layers", 0))):
        payload = chunks[b"HL%02d" % li]
        n_l, m_l = _HL_HEADER.unpack_from(payload)
        off = _HL_HEADER.size
        ids = np.frombuffer(payload, dtype="<i4", count=n_l, offset=off).astype(np.int32)
        off += n_l * 4
        nbrs = np.frombuffer(payload, dtype="<i4", count=n_l * m_l, offset=off)
        index.layers.append(HnswLayer(ids, to_device(nbrs.reshape(n_l, m_l), dev, torch.int32),
                                      index.x))
    return index
