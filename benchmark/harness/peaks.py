"""The yardstick's table of peaks and its counts of work.

Peaks are NVIDIA's data sheet for the H100 SXM part, dense rates, at its
full power limit of 700 W; the harness prints the card's own limit beside
every share it reports.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12


def hop_merge_bound_s(b: int, e: int, a: int, pw: int) -> tuple[float, str]:
    """Least time for one launch of the fused hop-merge (K1) on [B, E]
    discoveries and a [B, A] queue promoting `pw`: each input read once and
    each output written once over HBM (distances and ids, 4 bytes each), or
    its bitonic compare-exchanges at the f32 rate, whichever is larger.
    Returns (seconds, "bytes" | "operations")."""
    ep = 1 << max(e - 1, 0).bit_length()
    n_merge = 1 << (a + e - 1).bit_length()
    lg_ep, lg_l = ep.bit_length() - 1, n_merge.bit_length() - 1
    exchanges = b * (2 * (ep // 2) * lg_ep * (lg_ep + 1) // 2 + (n_merge // 2) * lg_l)
    bytes_moved = b * ((e + a) * 8 + (pw + a) * 8)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, exchanges / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bert_layer_params(hidden: int, intermediate: int) -> int:
    """Parameters of one BERT layer: fused q/k/v, output, two FFN
    projections (weights and biases) and two LayerNorms."""
    h, i = hidden, intermediate
    return (h * 3 * h + 3 * h) + (h * h + h) + (h * i + i) + (i * h + h) + 4 * h


def encoder_flops_per_token(hidden: int, intermediate: int, layers: int, seq: int) -> float:
    """Forward FLOPs per token: 2 x the non-embedding parameters (every
    weight multiplies once per token) + 4 x L x h per layer (the q.k scores
    and the probability-weighted values over L keys)."""
    return (2.0 * layers * bert_layer_params(hidden, intermediate)
            + 4.0 * seq * hidden * layers)
