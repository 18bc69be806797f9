"""Top-level application config (reference: src/config.rs:10-88).

Port of islands_tpu/config.py, a copy but for `indexer_config()`, which
builds the port's IndexerConfig. The device is not a config field: the CLI
takes it as `--device`.

`Config` with env (`from_env`: ISLANDS_DEBUG / ISLANDS_LOG_LEVEL /
ISLANDS_REPOS_PATH / ISLANDS_INDEXES_PATH incl. STORAGE__ variants,
OPENAI_API_KEY) and file loading (`from_file`: YAML by extension, else JSON).
Also honors the `leann:` block the reference's example config advertises but
never parses (islands.example.yaml:25-36 — a spec-vs-code gap this build
closes)."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


class ConfigFileError(ValueError):
    pass


@dataclasses.dataclass
class Config:
    debug: bool = False
    log_level: str = "info"
    base_path: str = ".islands"
    repos_path: str | None = None
    indexes_path: str | None = None
    openai_api_key: str | None = None
    mcp_host: str = "0.0.0.0"
    mcp_port: int = 8080
    embedding_kind: str = "hash"  # "hash" | "encoder"
    embedding_model: str = "bge-small"
    # LEANN recompute deployment: token table on disk, no [n, d] floats;
    # search recomputes embeddings (requires embedding_kind="encoder").
    embedding_recompute: bool = False
    chunk_size: int = 512
    chunk_overlap: int = 64
    # leann engine knobs (islands.example.yaml leann: block)
    leann_m: int = 16
    leann_m0: int = 32
    leann_ef_construction: int = 100
    leann_ef_search: int = 64
    # Search operating-point knobs (design.md §13); None keeps the
    # conservative gate-appropriate defaults.
    leann_promote_width: int | None = None
    leann_max_search_iters: int | None = None
    pq_enabled: bool = False
    pq_subquantizers: int = 8

    @staticmethod
    def from_env(base: "Config | None" = None) -> "Config":
        """(reference: config.rs:39-66)"""
        cfg = base or Config()
        env = os.environ

        def first(*names):
            for n in names:
                if n in env:
                    return env[n]
            return None

        if (v := first("ISLANDS_DEBUG")) is not None:
            cfg.debug = v.lower() in ("1", "true", "yes")
        if (v := first("ISLANDS_LOG_LEVEL")) is not None:
            cfg.log_level = v
        if (v := first("ISLANDS_BASE_PATH")) is not None:
            cfg.base_path = v
        if (v := first("ISLANDS_REPOS_PATH", "ISLANDS_STORAGE__REPOS_PATH")) is not None:
            cfg.repos_path = v
        if (v := first("ISLANDS_INDEXES_PATH", "ISLANDS_STORAGE__INDEXES_PATH")) is not None:
            cfg.indexes_path = v
        if (v := first("OPENAI_API_KEY")) is not None:
            cfg.openai_api_key = v
        return cfg

    @staticmethod
    def from_file(path: str | Path) -> "Config":
        """YAML by extension, else JSON (reference: config.rs:68-88)."""
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            try:
                import yaml  # type: ignore

                raw = yaml.safe_load(text)
            except ImportError:
                raw = _parse_simple_yaml(text)
        else:
            try:
                raw = json.loads(text)
            except json.JSONDecodeError as e:
                raise ConfigFileError(f"invalid JSON config: {e}") from e
        if not isinstance(raw, dict):
            raise ConfigFileError("config root must be a mapping")
        return Config._from_raw(raw)

    @staticmethod
    def _from_raw(raw: dict) -> "Config":
        cfg = Config()
        flat = dict(raw)
        # nested sections: indexer:, leann:, embedding:, mcp:
        for section, prefix in (
            ("indexer", ""), ("leann", "leann_"), ("embedding", "embedding_"),
            ("mcp", "mcp_"), ("pq", "pq_"),
        ):
            sub = raw.get(section)
            if isinstance(sub, dict):
                for k, v in sub.items():
                    flat.setdefault(f"{prefix}{k}" if prefix else k, v)
        fields = {f.name for f in dataclasses.fields(Config)}
        for k, v in flat.items():
            if k in fields and v is not None:
                setattr(cfg, k, v)
        if "enabled" in (raw.get("pq") or {}):
            cfg.pq_enabled = bool(raw["pq"]["enabled"])
        return cfg

    #: never serialized by to_yaml (config init must not write secrets from
    #: the environment into a file users commit)
    _SECRET_FIELDS = ("openai_api_key",)

    def to_yaml(self) -> str:
        """`config show` / `config init` output (reference: commands.rs:366-390).
        Secrets are omitted — provide them via environment variables."""
        lines = ["# islands-tpu configuration",
                 "# (secrets like OPENAI_API_KEY come from the environment)"]
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or f.name in self._SECRET_FIELDS:
                continue
            if isinstance(v, bool):
                v = "true" if v else "false"
            lines.append(f"{f.name}: {v}")
        return "\n".join(lines) + "\n"

    def indexer_config(self):
        from islands_tpu_torch.core.config import LeannConfig, PQConfig
        from islands_tpu_torch.indexer.service import EmbeddingConfig, IndexerConfig

        return IndexerConfig(
            base_path=self.base_path,
            repos_path_override=self.repos_path,
            indexes_path_override=self.indexes_path,
            chunk_size=self.chunk_size,
            chunk_overlap=self.chunk_overlap,
            embedding=EmbeddingConfig(
                kind=self.embedding_kind, model=self.embedding_model,
                recompute=self.embedding_recompute,
            ),
            leann=LeannConfig(
                m=self.leann_m,
                m0=self.leann_m0,
                ef_construction=max(self.leann_ef_construction, self.leann_m),
                ef_search=self.leann_ef_search,
                promote_width=self.leann_promote_width,
                max_search_iters=self.leann_max_search_iters,
                wave_size=512,
                intra_wave_k=min(16, self.leann_m0),
                reverse_slack=self.leann_m0,
                # Real encoder embeddings live on a low-dim manifold, where
                # the sketch-gated query holds exact-path recall (design.md
                # §10); hash embeddings are near-uniform, keep exact.
                sketch_query=(self.embedding_kind == "encoder"),
            ),
            pq=PQConfig(num_subquantizers=self.pq_subquantizers)
            if self.pq_enabled else None,
        )


def _parse_simple_yaml(text: str) -> dict:
    """Minimal YAML subset parser (scalars + one nesting level) used when
    PyYAML is unavailable; enough for islands.example.yaml-style configs."""
    root: dict = {}
    current: dict | None = None
    for line in text.splitlines():
        if not line.strip() or line.strip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        value = value.split("#", 1)[0].strip()
        if indent == 0:
            if value == "":
                current = {}
                root[key] = current
            else:
                root[key] = _yaml_scalar(value)
                current = None
        elif current is not None:
            current[key] = _yaml_scalar(value)
    return root


def _yaml_scalar(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v.strip("'\"")
