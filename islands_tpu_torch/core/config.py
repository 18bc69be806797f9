"""Configuration types for the LEANN-style index.

Port of islands_tpu/core/config.py: `DistanceMetric`, `PruningStrategy`,
`LeannConfig`, `HnswConfig`, `PQConfig` and `SearchConfig` with the same
fields in the same order, defaults, presets and `validate()` (storage
writes `dataclasses.asdict(config)`, so the order is part of the file
format), and `distance_to_similarity`.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class DistanceMetric(str, enum.Enum):
    """Distance metrics; all are distances (lower is better).
    - COSINE: 1 - cosine_similarity (zero vectors -> 1.0)
    - EUCLIDEAN: L2 distance
    - DOT_PRODUCT: negative dot product
    - MANHATTAN: L1 distance
    """

    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    DOT_PRODUCT = "dotproduct"
    MANHATTAN = "manhattan"


class PruningStrategy(str, enum.Enum):
    """Candidate-pruning strategies before embedding recompute."""

    GLOBAL = "global"
    LOCAL = "local"
    PROPORTIONAL = "proportional"


class ConfigError(ValueError):
    """Invalid configuration."""


@dataclasses.dataclass(frozen=True)
class LeannConfig:
    """LEANN index configuration. Field meanings are documented on the
    reference's LeannConfig (islands_tpu/core/config.py); the batched build
    and search knobs (wave_size, expand_width, reverse_slack, intra_wave_k,
    sketch_*) keep their names and defaults."""

    m: int = 30
    m0: int = 60
    ef_construction: int = 128
    ml: float = 1.0 / math.log(30.0)
    max_layers: int = 16
    metric: DistanceMetric = DistanceMetric.COSINE
    ef_search: int = 64
    beam_width: int = 1
    prune_ratio: float = 0.0
    pruning_strategy: PruningStrategy = PruningStrategy.GLOBAL
    high_degree_pruning: bool = True
    hub_percentile: float = 0.02
    is_compact: bool = True
    is_recompute: bool = True
    diversify: bool = True
    sketch_build: bool = True
    sketch_dims: int = 16
    sketch_pool_mult: int = 2
    routing_size: int = 1024
    refine_passes: int = 0
    sketch_query: bool = False
    wave_size: int = 1024
    expand_width: int = 4
    reverse_slack: int = 60
    intra_wave_k: int = 30
    seed: int = 0
    promote_width: int | None = None
    max_search_iters: int | None = None

    @staticmethod
    def paper_default() -> "LeannConfig":
        return LeannConfig()

    @staticmethod
    def fast() -> "LeannConfig":
        return LeannConfig(m=16, m0=32, ef_construction=100, ef_search=32,
                           prune_ratio=0.3, reverse_slack=32, intra_wave_k=16)

    @staticmethod
    def accurate() -> "LeannConfig":
        return LeannConfig(m=48, m0=96, ef_construction=400, ef_search=128,
                           prune_ratio=0.0, reverse_slack=96, intra_wave_k=48)

    def validate(self) -> None:
        if self.m <= 0:
            raise ConfigError("M must be > 0")
        if self.m0 < self.m:
            raise ConfigError("M0 must be >= M")
        if self.ef_construction < self.m:
            raise ConfigError("ef_construction must be >= M")
        if not 0.0 <= self.prune_ratio <= 1.0:
            raise ConfigError("prune_ratio must be in [0.0, 1.0]")
        if self.beam_width <= 0:
            raise ConfigError("beam_width must be > 0")
        if not 0.0 <= self.hub_percentile <= 1.0:
            raise ConfigError("hub_percentile must be in [0.0, 1.0]")
        if self.promote_width is not None and self.promote_width <= 0:
            raise ConfigError("promote_width must be > 0 when set")
        if self.max_search_iters is not None and self.max_search_iters <= 0:
            raise ConfigError("max_search_iters must be > 0 when set")
        if self.refine_passes < 0:
            raise ConfigError("refine_passes must be >= 0")
        if self.wave_size <= 0:
            raise ConfigError("wave_size must be > 0")
        if self.expand_width <= 0:
            raise ConfigError("expand_width must be > 0")


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Multi-layer HNSW configuration: m links per upper-layer node, m0 at
    layer 0, geometric levels with factor `ml`; the batched build knobs as in
    LeannConfig."""

    m: int = 16
    m0: int = 32
    ef_construction: int = 200
    ml: float = 1.0 / math.log(16.0)
    max_layers: int = 16
    metric: DistanceMetric = DistanceMetric.COSINE
    wave_size: int = 1024
    expand_width: int = 4
    reverse_slack: int = 32
    intra_wave_k: int = 16
    seed: int = 0

    @staticmethod
    def fast() -> "HnswConfig":
        return HnswConfig(m=8, m0=16, ef_construction=100,
                          ml=1.0 / math.log(8.0), reverse_slack=16, intra_wave_k=8)

    @staticmethod
    def accurate() -> "HnswConfig":
        return HnswConfig(m=32, m0=64, ef_construction=400,
                          ml=1.0 / math.log(32.0), reverse_slack=64, intra_wave_k=32)

    def validate(self) -> None:
        if self.m <= 0:
            raise ConfigError("m must be > 0")
        if self.m0 < self.m:
            raise ConfigError("m0 must be >= m")
        if self.ef_construction < self.m:
            raise ConfigError("ef_construction must be >= m")
        if self.max_layers <= 0:
            raise ConfigError("max_layers must be > 0")

    def to_leann(self, layer: int) -> LeannConfig:
        """Per-layer construction parameters: m0 links at layer 0, m above."""
        m_l = self.m0 if layer == 0 else self.m
        return LeannConfig(
            m=max(m_l // 2, 1), m0=m_l, ef_construction=max(self.ef_construction, m_l),
            ml=self.ml, max_layers=1, metric=self.metric, high_degree_pruning=False,
            wave_size=self.wave_size, expand_width=self.expand_width,
            reverse_slack=self.reverse_slack, intra_wave_k=min(self.intra_wave_k, m_l),
            seed=self.seed + layer)


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product quantization configuration: `num_subquantizers` subspaces of
    `num_centroids` centroids each, trained by k-means for
    `training_iterations` Lloyd steps from a k-means++ start seeded by
    `seed` (None means 0)."""

    num_subquantizers: int = 8
    num_centroids: int = 256
    training_iterations: int = 25
    seed: int | None = None

    def validate(self, dimension: int) -> None:
        if self.num_subquantizers <= 0:
            raise ConfigError("num_subquantizers must be > 0")
        if dimension % self.num_subquantizers != 0:
            raise ConfigError(
                f"dimension {dimension} must be divisible by "
                f"num_subquantizers {self.num_subquantizers}")
        if not 1 <= self.num_centroids <= 65536:
            raise ConfigError("num_centroids must be in range [1, 65536]")

    @property
    def bytes_per_vector(self) -> int:
        """Stored code bytes per vector: one per subspace up to 256
        centroids, two above (the reference's on-disk u16 codes)."""
        if self.num_centroids <= 256:
            return self.num_subquantizers
        return self.num_subquantizers * 2


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search-time configuration of the search API (core/searchapi.py):
    `promote_width` and `max_iters` are passed on to indexes whose search
    takes them; None keeps the index's defaults."""

    top_k: int = 10
    ef: int = 100
    include_vectors: bool = False
    include_metadata: bool = True
    min_similarity: float | None = None
    rerank_ratio: float = 0.1
    promote_width: int | None = None
    max_iters: int | None = None

    def validate(self) -> None:
        if self.top_k <= 0:
            raise ConfigError("top_k must be > 0")
        if self.ef < self.top_k:
            raise ConfigError("ef must be >= top_k")
        if self.promote_width is not None and self.promote_width <= 0:
            raise ConfigError("promote_width must be > 0 when set")
        if self.max_iters is not None and self.max_iters <= 0:
            raise ConfigError("max_iters must be > 0 when set")


def distance_to_similarity(distance: float) -> float:
    """similarity = 1 / (1 + distance)."""
    return 1.0 / (1.0 + distance)
