"""ModernBERT's work counts for the readers of the ModernBERT cells, and
the length law their chunks are cut to.

Counted from the configuration's widths and the segment lengths the driver
drew, never from what the program did, so a count is the same whatever
computes it. A segment of s tokens runs alone (unpadded):

- dense work: 2 FLOPs per weight per token, over the matrix weights of
  every layer (Wqkv h x 3h, Wo h x h, Wi h x 2i, the MLP's Wo i x h; the
  LayerNorm scales are left out, 0.03% of them);
- attention: 4 x h FLOPs per (query, key) pair attended (q.k and the
  weighted sum of v, over all heads): s^2 pairs in a global layer, the
  band's pairs (|q - k| <= w) in a local one.

The attention kernel's least time for one layer over a forward's segments
is the larger of its FLOPs at the dense bf16 peak and its bytes (q, k and v
read and the output written once, bf16) at HBM's rate; a forward's is the
sum over its layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness.peaks import BF16_TC_FLOPS_PER_S, HBM_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class Widths:
    hidden: int
    intermediate: int
    layers: int
    global_every: int
    window: int  # a local layer's keys lie within +/- window of the query

    @staticmethod
    def from_config(enc: dict) -> "Widths":
        return Widths(int(enc["hidden_size"]), int(enc["intermediate_size"]),
                      int(enc["num_hidden_layers"]), int(enc["global_attn_every_n_layers"]),
                      int(enc["local_attention"]) // 2)

    @property
    def global_layers(self) -> int:
        return len(range(0, self.layers, self.global_every))

    @property
    def local_layers(self) -> int:
        return self.layers - self.global_layers


def log_uniform_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """The ModernBERT cells' length law: n lengths spread evenly in log over
    [lo, hi] (the same for every seed; the driver shuffles them)."""
    return np.rint(lo * (hi / lo) ** ((np.arange(n) + 0.5) / n)).astype(np.int64)


def band_pairs(lengths, w: int) -> np.ndarray:
    """Pairs (q, k) with |q - k| <= w inside each segment of s tokens."""
    s = np.asarray(lengths, dtype=np.int64)
    m = np.minimum(w, np.maximum(s - 1, 0))
    return s + 2 * m * s - m * (m + 1)


def dense_flops_per_token(wd: Widths) -> float:
    h, i = wd.hidden, wd.intermediate
    return 2.0 * wd.layers * (4 * h * h + 3 * h * i)


def attention_flops(lengths, wd: Widths) -> np.ndarray:
    """Attention FLOPs of each segment over all layers."""
    s = np.asarray(lengths, dtype=np.float64)
    return 4.0 * wd.hidden * (wd.global_layers * s * s
                              + wd.local_layers * band_pairs(lengths, wd.window))


def segment_flops(lengths, wd: Widths) -> np.ndarray:
    """The whole forward's FLOPs of each segment."""
    return np.asarray(lengths, dtype=np.float64) * dense_flops_per_token(wd) + \
        attention_flops(lengths, wd)


def attention_bound_s(lengths, wd: Widths) -> float:
    """Least time of the attention kernel over one forward of these
    segments: per layer max(FLOPs / peak, bytes / HBM rate), summed."""
    s = np.asarray(lengths, dtype=np.float64)
    if s.size == 0:
        return 0.0
    nbytes = 4.0 * s.sum() * wd.hidden * 2
    out = 0.0
    for pairs, n in ((float((s * s).sum()), wd.global_layers),
                     (float(band_pairs(lengths, wd.window).sum()), wd.local_layers)):
        out += n * max(4.0 * wd.hidden * pairs / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return out
