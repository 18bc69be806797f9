"""Mellum 2 (JetBrains' mixture-of-experts code model) as a sentence encoder.

Mellum2-12B-A2.5B (https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct,
config.json) used as a code-embedding backbone with last-token pooling, as
e5-mistral (arXiv:2401.00368) pools a decoder LLM. Per packed segment,
positions restarting at 0 in each:

- x = embed[ids];
- each layer: h = x + o(attn(rmsnorm(x))), then x = h + moe(rmsnorm(h));
- attn: grouped-query attention (32 query heads, 4 key/value heads of
  128; query head j reads key head j // 8), q and k rotated by the layer
  type's RoPE tables, scale 1/sqrt(head_dim), causal; a sliding layer
  (three of every four: `layer_types`) also requires i - j < 1,024;
- RoPE theta 500,000: plain on the sliding layers; YaRN on the full ones
  (factor 16 over an original 8,192 positions, beta_fast 32, beta_slow 1),
  its inverse frequencies and `attention_factor` computed as HF
  transformers' `_compute_yarn_parameters` computes them (the correction
  range floored and ceiled, the ramp blending interpolated and
  extrapolated frequencies, cos and sin multiplied by the factor);
- moe(y) = sum over the top 8 of 64 SwiGLU experts of width 896 of
  w_e * down_e(silu(gate_e(y)) * up_e(y)), w the router's float32 softmax
  over its 64 logits, the top 8 renormalised to sum to 1 (`ops/moe`);
- a final RMSNorm (eps 1e-6); the embedding is each segment's last valid
  token's final hidden state.

What the config leaves unsaid, and the departures: no q/k norm, no
attention, MLP or router biases, no shared expert (the config declares
none); the LM head and the multi-token-prediction head are dropped, since
an embedder pools hidden states; the dense `intermediate_size` (7,168) is
unused, every layer's MLP being sparse (`mlp_layer_types`).

Precision: the products in bf16 (the model's dtype) with float32 sums;
the residual stream, RMSNorm, RoPE, softmax statistics, router, SwiGLU and
pooling in float32. The weights are a dict of device tensors that the
model keeps as it is given them (`init_params` layout, dense weights
[in, out], layers stacked on axis 0): no host copy and no second device
copy is made, so an 11.9B-parameter model takes its 23.8 GB of bf16 once.

One forward, unpadded as ModernBERT's (`models/modernbert`): the valid
tokens of n segments end to end with their `Segments`, attention through
`ops/varlen_attention` in its causal and grouped-query modes, the experts
through `ops/moe`. `bert.encode` (via `MellumModel.pooled`), the text
encoder and the recompute provider (via `MellumModel.pooled_rows`) run
`forward_packed`; its always-on `forward_packed.tokens_encoded` counts the
tokens it has encoded. Under tracing it counts "encoder.tokens" and
"encoder.segments", and each layer's MLP opens "moe.route" (router to
sorted runs, counting "moe.assignments") and "moe.experts" (the grouped
products, the passes around them and the combine into the residual).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from islands_tpu_torch.models.bert import compute_dtype
from islands_tpu_torch.models import modernbert
from islands_tpu_torch.models.modernbert import Segments, pack_rows
from islands_tpu_torch.ops import moe
from islands_tpu_torch.ops.varlen_attention import varlen_attention
from islands_tpu_torch.utils.tracing import count, region

__all__ = ["MellumConfig", "MellumModel", "forward_packed", "init_params", "rope_tables",
           "yarn_inv_freq"]

#: Most tokens one packed forward takes; longer work is cut into chunks of
#: whole segments (`token_chunks`). At 32,768 tokens the
#: experts' sorted rows, [gate | up] products, intermediate and outputs
#: take 3.8 GB in bf16.
PACK_TOKENS = 1 << 15

SLIDING, FULL = "sliding_attention", "full_attention"


def token_chunks(lengths, budget: int = PACK_TOKENS) -> list[tuple[int, int]]:
    """`modernbert.token_chunks` at Mellum's budget."""
    return modernbert.token_chunks(lengths, budget)


@dataclasses.dataclass(frozen=True)
class MellumConfig:
    """Architecture hyperparameters (the HF config.json's, `from_hf`)."""

    vocab_size: int = 98304
    hidden_size: int = 2304
    num_hidden_layers: int = 28
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int = 128
    moe_intermediate_size: int = 896
    num_experts: int = 64
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    sliding_window: int = 1024
    layer_types: tuple = ((SLIDING,) * 3 + (FULL,)) * 7
    rope_theta: float = 500000.0
    yarn_factor: float = 16.0
    yarn_original_max_position_embeddings: int = 8192
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.2772588722239782
    max_position_embeddings: int = 131072
    dtype: str = "bfloat16"

    @staticmethod
    def mellum2_12b_a2_5b() -> "MellumConfig":
        """Mellum2-12B-A2.5B at its published widths (no LM head)."""
        return MellumConfig()

    @staticmethod
    def tiny_test() -> "MellumConfig":
        """Small config for tests: one whole period (3 sliding layers, then
        1 full), window 8 and YaRN over an original 16 positions, so that
        the window and the ramp both bind at test lengths."""
        return MellumConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=4,
                            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                            moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
                            sliding_window=8, layer_types=(SLIDING,) * 3 + (FULL,),
                            yarn_factor=4.0, yarn_original_max_position_embeddings=16,
                            yarn_attention_factor=0.1 * math.log(4.0) + 1.0,
                            max_position_embeddings=64, dtype="float32")

    @staticmethod
    def from_hf(raw: dict) -> "MellumConfig":
        """From the keys of a Mellum config.json (`rope_parameters` holding a
        "sliding_attention" and a "full_attention" entry)."""
        rope = raw["rope_parameters"]
        full, sliding = rope[FULL], rope[SLIDING]
        if sliding.get("rope_type", "default") != "default" or full["rope_type"] != "yarn" \
                or sliding["rope_theta"] != full["rope_theta"]:
            raise ValueError(f"Mellum takes plain RoPE on its sliding layers and YaRN on its "
                             f"full layers with one theta, got {rope}")
        if set(raw.get("mlp_layer_types", ["sparse"])) != {"sparse"}:
            raise ValueError("this Mellum forward takes sparse MLPs on every layer")
        factor = float(full["factor"])
        attn = full.get("attention_factor")
        return MellumConfig(
            vocab_size=int(raw["vocab_size"]), hidden_size=int(raw["hidden_size"]),
            num_hidden_layers=int(raw["num_hidden_layers"]),
            num_attention_heads=int(raw["num_attention_heads"]),
            num_key_value_heads=int(raw["num_key_value_heads"]), head_dim=int(raw["head_dim"]),
            moe_intermediate_size=int(raw["moe_intermediate_size"]),
            num_experts=int(raw["num_experts"]),
            num_experts_per_tok=int(raw["num_experts_per_tok"]),
            norm_topk_prob=bool(raw["norm_topk_prob"]), rms_norm_eps=float(raw["rms_norm_eps"]),
            sliding_window=int(raw["sliding_window"]), layer_types=tuple(raw["layer_types"]),
            rope_theta=float(full["rope_theta"]), yarn_factor=factor,
            yarn_original_max_position_embeddings=int(full["original_max_position_embeddings"]),
            yarn_beta_fast=float(full.get("beta_fast") or 32),
            yarn_beta_slow=float(full.get("beta_slow") or 1),
            yarn_attention_factor=float(attn if attn is not None
                                        else 0.1 * math.log(factor) + 1.0),
            max_position_embeddings=int(raw["max_position_embeddings"]),
            dtype=str(raw.get("dtype", "bfloat16")))

    def to_hf(self) -> dict:
        """The config.json keys `from_hf` reads, for this config."""
        full = {"rope_type": "yarn", "rope_theta": self.rope_theta, "factor": self.yarn_factor,
                "original_max_position_embeddings": self.yarn_original_max_position_embeddings,
                "beta_fast": self.yarn_beta_fast, "beta_slow": self.yarn_beta_slow,
                "attention_factor": self.yarn_attention_factor}
        return {
            "vocab_size": self.vocab_size, "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads, "head_dim": self.head_dim,
            "moe_intermediate_size": self.moe_intermediate_size,
            "num_experts": self.num_experts, "num_experts_per_tok": self.num_experts_per_tok,
            "norm_topk_prob": self.norm_topk_prob, "rms_norm_eps": self.rms_norm_eps,
            "sliding_window": self.sliding_window, "layer_types": list(self.layer_types),
            "mlp_layer_types": ["sparse"] * self.num_hidden_layers,
            "rope_parameters": {FULL: full, SLIDING: {"rope_type": "default",
                                                      "rope_theta": self.rope_theta}},
            "max_position_embeddings": self.max_position_embeddings, "dtype": self.dtype}

    @property
    def q_width(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.num_key_value_heads * self.head_dim


def param_shapes(config: MellumConfig) -> dict:
    """(group, name) -> shape of every weight, in `init_params`' layout."""
    h, n_l, e, i = (config.hidden_size, config.num_hidden_layers, config.num_experts,
                    config.moe_intermediate_size)
    return {
        (None, "embed"): (config.vocab_size, h),
        ("layers", "attn_norm"): (n_l, h),
        ("layers", "qkv_w"): (n_l, h, config.q_width + 2 * config.kv_width),
        ("layers", "o_w"): (n_l, config.q_width, h),
        ("layers", "mlp_norm"): (n_l, h),
        ("layers", "router_w"): (n_l, h, e),
        ("layers", "gate_up_w"): (n_l, e, h, 2 * i),
        ("layers", "down_w"): (n_l, e, i, h),
        (None, "final_norm"): (h,),
    }


def init_params(config: MellumConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights drawn on `device` from a torch generator, one layer's
    tensor at a time (float32 draws, stored in the config's dtype; the
    norm scales kept in float32): weights N(0, 0.02^2), RMSNorm scales
    1 + N(0, 0.05^2). Layout: `embed` [V, h], `final_norm` [h], and under
    `layers`, stacked over the layers, `attn_norm` [h], `qkv_w` [h, (nq +
    2 nkv) d] (q, k, v columns in that order), `o_w` [nq d, h], `mlp_norm`
    [h], `router_w` [h, E], `gate_up_w` [E, h, 2i] (each expert's gate
    columns, then its up columns), `down_w` [E, i, h]."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = compute_dtype(config.dtype)
    out: dict = {"layers": {}}
    for (group, name), shape in param_shapes(config).items():
        norm = name.endswith("norm")
        t = torch.empty(shape, dtype=torch.float32 if norm else dtype, device=dev)
        for part in (t if group == "layers" else t[None]):
            draw = torch.randn(part.shape, generator=gen, device=dev)
            part.copy_(draw * 0.05 + 1.0 if norm else draw * 0.02)
        (out["layers"] if group == "layers" else out)[name] = t
    return out


def yarn_inv_freq(config: MellumConfig) -> tuple[torch.Tensor, float]:
    """YaRN's inverse frequencies [head_dim / 2] float32 and its attention
    factor, as HF transformers' `_compute_yarn_parameters`."""
    dim, base = config.head_dim, config.rope_theta
    orig, factor = config.yarn_original_max_position_embeddings, config.yarn_factor

    def correction_dim(rotations: float) -> float:
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(config.yarn_beta_fast)), 0)
    high = min(math.ceil(correction_dim(config.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extrapolation = 1 - ramp
    inv = (1.0 / (factor * pos_freqs)) * (1 - extrapolation) + (1.0 / pos_freqs) * extrapolation
    return inv, config.yarn_attention_factor


def rope_tables(config: MellumConfig, kind: str, n_pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [n_pos, head_dim] float32 of a layer type (rotate-half
    layout), as HF's rotary embedding computes them: float32 frequencies
    times float32 positions, YaRN's scaled by its attention factor."""
    if kind == FULL:
        inv, scale = yarn_inv_freq(config)
    else:
        inv = 1.0 / (config.rope_theta ** (torch.arange(0, config.head_dim, 2,
                                                         dtype=torch.float32) / config.head_dim))
        scale = 1.0
    freqs = torch.arange(n_pos, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of float32 x with float32 scales -> float32."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


class MellumModel(nn.Module):
    """Mellum on packed segments: `hidden_packed` gives their final hidden
    states, `pooled` and `pooled_rows` each segment's last token's, of a
    padded batch or of rows of a token table. Holds `weights` (a dict in
    `init_params`' layout) as given, moved to `device` only if elsewhere."""

    def __init__(self, config: MellumConfig, weights: dict, device=None):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        dev = torch.device(device) if device is not None else weights["embed"].device
        want = {name: shape for (_, name), shape in param_shapes(config).items()}
        flat = {"embed": weights["embed"], "final_norm": weights["final_norm"],
                **weights["layers"]}
        if set(flat) != set(want):
            raise ValueError(f"Mellum weights {sorted(flat)}, want {sorted(want)}")
        for name, t in flat.items():
            if tuple(t.shape) != tuple(want[name]):
                raise ValueError(f"Mellum weight {name} is {tuple(t.shape)}, want {want[name]}")
            norm = name.endswith("norm")
            if norm and t.dtype != torch.float32 or not norm and t.dtype != self.dtype:
                raise TypeError(f"Mellum weight {name} is {t.dtype}")
        self.w = {name: torch.as_tensor(t).to(dev) for name, t in flat.items()}
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.w["embed"].device

    def _tables(self, kind: str, max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
        n_pos = max(1024, 1 << max(max_len - 1, 0).bit_length())
        key = (kind, n_pos)
        if key not in self._rope:
            self._rope[key] = tuple(t.to(self.device)
                                    for t in rope_tables(self.config, kind, n_pos))
        return self._rope[key]

    def hidden_packed(self, ids: torch.Tensor, segs: Segments) -> torch.Tensor:
        """Packed ids [T] of the segments `segs` -> final hidden states
        [T, H] float32 (after the final norm)."""
        cfg, w, dt = self.config, self.w, self.dtype
        eps, t = cfg.rms_norm_eps, ids.shape[0]
        nq, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        qw, kw = cfg.q_width, cfg.kv_width
        x = w["embed"][ids.long()].float()
        for i, kind in enumerate(cfg.layer_types):
            qkv = rms_norm(x, w["attn_norm"][i], eps).to(dt) @ w["qkv_w"][i]
            ctx = varlen_attention(
                qkv[:, :qw].view(t, nq, d), qkv[:, qw:qw + kw].view(t, nkv, d),
                qkv[:, qw + kw:].view(t, nkv, d), segs,
                cfg.sliding_window if kind == SLIDING else None,
                rope=self._tables(kind, segs.max_len), causal=True)
            x += ctx.view(t, qw) @ w["o_w"][i]
            self._moe(rms_norm(x, w["mlp_norm"][i], eps), i, x)
        return rms_norm(x, w["final_norm"], eps)

    def _moe(self, y: torch.Tensor, i: int, x: torch.Tensor) -> None:
        """Layer i's sparse MLP of y [T, h] float32, added into x."""
        cfg, w = self.config, self.w
        with region("moe.route"):
            r = moe.route(y, w["router_w"][i], cfg.num_experts_per_tok, cfg.norm_topk_prob)
            count("moe.assignments", r.assignments)
        with region("moe.experts"):
            moe.moe_gemm(y, r, w["gate_up_w"][i], w["down_w"][i], out=x)

    def pooled(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """A padded batch [B, L] (each mask a prefix of ones) through
        `forward_packed` -> each row's last token's final hidden state
        [B, H] float32 (not normalised)."""
        with region("encoder.pack"):
            lens = attention_mask.sum(dim=1).cpu().numpy()
        rows = torch.arange(input_ids.shape[0], device=input_ids.device)
        return self.pooled_rows(input_ids, rows, lens)

    def pooled_rows(self, table: torch.Tensor, rows: torch.Tensor, lengths) -> torch.Tensor:
        """Rows `rows` of a padded token table [N, L], their first
        `lengths[j]` ids each (host integers), packed and run in chunks of
        whole rows of at most PACK_TOKENS tokens -> last-token pooled
        [n, H] float32 (not normalised)."""
        out = torch.empty((rows.numel(), self.config.hidden_size), dtype=torch.float32,
                          device=table.device)
        for s, e in token_chunks(lengths):
            ids, segs = pack_rows(table, rows[s:e], lengths[s:e])
            out[s:e] = forward_packed(self, ids, segs)
        return out


def last_tokens(hidden: torch.Tensor, segs: Segments) -> torch.Tensor:
    """Each segment's last row of [T, H] -> [n, H] (zeros for an empty
    segment)."""
    if segs.count == 0:
        return hidden.new_zeros((0, hidden.shape[1]))
    last = segs.cu_seqlens[1:].long() - 1
    rows = torch.cat([hidden, hidden.new_zeros((1, hidden.shape[1]))])
    empty = torch.from_numpy(np.asarray(segs.lengths) == 0).to(hidden.device, non_blocking=True)
    return rows[torch.where(empty, hidden.shape[0], last)]


@torch.inference_mode()
def forward_packed(model: MellumModel, ids: torch.Tensor, segs: Segments) -> torch.Tensor:
    """Mellum on packed ids [T] of the segments `segs` -> each segment's
    last token's final hidden state [n, H] float32 (not normalised).
    Counts its tokens in `forward_packed.tokens_encoded` and, under
    tracing, "encoder.tokens" and "encoder.segments"."""
    if segs.tokens != ids.shape[0]:
        raise ValueError(f"segments hold {segs.tokens} tokens, ids has {ids.shape[0]}")
    count("encoder.tokens", segs.tokens)
    count("encoder.segments", segs.count)
    forward_packed.tokens_encoded += segs.tokens
    return last_tokens(model.hidden_packed(ids, segs), segs)


forward_packed.tokens_encoded = 0
