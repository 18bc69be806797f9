"""Utilities: tracing, metrics and logging. Port of islands_tpu/utils,
without its persistent compilation cache (a TPU workaround)."""

from islands_tpu_torch.utils.tracing import (
    JsonFormatter,
    Metrics,
    init_logging,
    metrics,
    record_recompute_efficiency,
    span,
)

__all__ = [
    "JsonFormatter", "Metrics", "init_logging", "metrics",
    "record_recompute_efficiency", "span",
]
