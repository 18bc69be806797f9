"""Configuration types for the LEANN-style index.

Port of islands_tpu/core/config.py: `DistanceMetric`, `PruningStrategy` and
`LeannConfig` with the same fields, defaults, presets and `validate()`. The
PQ, HNSW and search configs come with the slices that use them.
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
