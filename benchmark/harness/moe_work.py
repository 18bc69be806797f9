"""Mellum's work counts for the readers of the Mellum cells.

Counted from the configuration's widths and the segment lengths the driver
drew, never from what the program did, so a count is the same whatever
computes it. A segment of s tokens runs alone (unpadded), causal:

- dense work: 2 FLOPs per active weight per token: every layer's q, k, v
  and o projections (h x (nq + 2 nkv) d and nq d x h), its router (h x E)
  and its top_k experts' gate, up and down (3 x h x i each); the RMSNorm
  scales are left out (0.01% of them);
- attention: 4 x nq x d FLOPs per (query, key) pair attended (q.k and the
  weighted sum of v, over all query heads): the causal pairs, s (s + 1) / 2,
  in a full layer, and those with i - j < window in a sliding one.

The grouped expert GEMM's least time for one forward of T tokens (A = T x
top_k assignments), per layer the larger of its FLOPs (6 x A x h x i) at
the dense bf16 peak and its bytes at HBM's rate: the weights of the
experts it must read once (min(E, A) of them, 3 x h x i x 2 bytes each)
and the activations in and out, once each (the tokens' rows in, T x h;
the permuted intermediate out and in, A x i twice; the weighted rows
out, A x h; bf16). A forward's is the sum over its layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness.peaks import BF16_TC_FLOPS_PER_S, HBM_BYTES_PER_S

SLIDING = "sliding_attention"


@dataclasses.dataclass(frozen=True)
class Widths:
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int
    top_k: int
    expert_width: int
    window: int  # a sliding layer's keys lie within i - window < j <= i
    layer_types: tuple

    @staticmethod
    def from_config(cfg: dict) -> "Widths":
        """From the Mellum config.json keys."""
        return Widths(int(cfg["hidden_size"]), int(cfg["num_attention_heads"]),
                      int(cfg["num_key_value_heads"]), int(cfg["head_dim"]),
                      int(cfg["num_experts"]), int(cfg["num_experts_per_tok"]),
                      int(cfg["moe_intermediate_size"]), int(cfg["sliding_window"]),
                      tuple(cfg["layer_types"]))

    @property
    def layers(self) -> int:
        return len(self.layer_types)

    @property
    def sliding_layers(self) -> int:
        return sum(t == SLIDING for t in self.layer_types)

    @property
    def full_layers(self) -> int:
        return self.layers - self.sliding_layers


def active_params_per_layer(wd: Widths) -> int:
    """The matrix weights one token multiplies in one layer."""
    h, d = wd.hidden, wd.head_dim
    attn = h * (wd.heads + 2 * wd.kv_heads) * d + wd.heads * d * h
    return attn + h * wd.experts + wd.top_k * 3 * h * wd.expert_width


def dense_flops_per_token(wd: Widths) -> float:
    return 2.0 * wd.layers * active_params_per_layer(wd)


def causal_pairs(lengths, window: int | None = None) -> np.ndarray:
    """Pairs (i, j) with 0 <= i - j (< window) inside each segment."""
    s = np.asarray(lengths, dtype=np.int64)
    if window is None:
        return s * (s + 1) // 2
    w = np.minimum(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_flops(lengths, wd: Widths) -> np.ndarray:
    """Attention FLOPs of each segment over all layers."""
    per_pair = 4.0 * wd.heads * wd.head_dim
    return per_pair * (wd.full_layers * causal_pairs(lengths)
                       + wd.sliding_layers * causal_pairs(lengths, wd.window))


def segment_flops(lengths, wd: Widths) -> np.ndarray:
    """The whole forward's FLOPs of each segment."""
    return np.asarray(lengths, dtype=np.float64) * dense_flops_per_token(wd) + \
        attention_flops(lengths, wd)


def experts_bound_s(tokens: int, wd: Widths) -> float:
    """Least time of the grouped expert GEMM over one forward of `tokens`
    tokens: per layer max(FLOPs / peak, bytes / HBM rate), summed."""
    t = int(tokens)
    a = t * wd.top_k
    if a == 0:
        return 0.0
    h, i = wd.hidden, wd.expert_width
    flops = 6.0 * a * h * i
    nbytes = 2.0 * (min(wd.experts, a) * 3 * h * i + t * h + a * (h + 2 * i))
    return wd.layers * max(flops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def attention_bound_s(lengths, wd: Widths) -> float:
    """Least time of the attention kernel over one forward of these
    segments: per layer the larger of its FLOPs at the peak and q, k, v
    read and the output written once (bf16) at HBM's rate, summed."""
    s = np.asarray(lengths, dtype=np.float64)
    if s.size == 0:
        return 0.0
    nbytes = 2.0 * s.sum() * wd.head_dim * (2 * wd.heads + 2 * wd.kv_heads)
    per_pair = 4.0 * wd.heads * wd.head_dim
    out = 0.0
    for pairs, n in ((float(causal_pairs(lengths).sum()), wd.full_layers),
                     (float(causal_pairs(lengths, wd.window).sum()), wd.sliding_layers)):
        out += n * max(per_pair * pairs / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return out
