"""ModernBERT sentence encoder, the second encoder architecture.

Port of islands_tpu/models/modernbert.py (answerdotai/ModernBERT):
- no position or token-type embeddings: rotary position embeddings (RoPE,
  rotate-half convention) applied to q and k inside attention;
- alternating attention: every `global_attn_every_n_layers`-th layer is
  global (full attention, rope theta 160k), the rest are local (a band of
  +/- local_attention // 2 tokens, rope theta 10k);
- pre-norm residual blocks with bias-free linears and LayerNorms; layer 0's
  attention norm is the identity (the embeddings are normed already);
- a gated MLP (GeGLU): Wi projects to 2 * intermediate, gelu(input) * gate;
- a final LayerNorm after the stack.

One forward, on the batch unpadded as the published model runs it
("unpadding"): the valid tokens of n segments end to end with their
offsets, RoPE positions restarting in each segment, each local layer
attending within its band inside its own segment and each global layer to
its whole segment through the varlen attention kernel
(`ops/varlen_attention`), then the final norm (`hidden_packed`) and a mean
over each segment's tokens (`forward_packed`). The JAX package computes
the same layers as dense attention over a padded batch with a band bias;
the tests hold this forward against it at the valid positions
(`ModernBertModel.forward` lays the packed hidden states out as the padded
batch). `bert.encode` on a ModernBERT model, and so the text encoder and
the recompute provider, run `forward_packed` (via `ModernBertModel.pooled`);
its always-on `forward_packed.tokens_encoded` counts the tokens it has
encoded, and under tracing it counts "encoder.tokens" and
"encoder.segments" and `pack_rows` opens "encoder.pack".

The reference keeps one `lax.scan` body by selecting the global or local
tables with per-layer float flags; here each layer knows its kind. Numerics
are the reference's: matmul operands in the compute dtype, RoPE tables and
softmax statistics in float32.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from islands_tpu_torch.models.bert import (
    compute_dtype,
    encode,
    layer_norm,
    mean_pool_normalize,
    read_checkpoint,
)
from islands_tpu_torch.ops.varlen_attention import Segments, varlen_attention
from islands_tpu_torch.utils.tracing import count, region

__all__ = ["ModernBertConfig", "ModernBertModel", "Segments", "encode", "forward_packed",
           "init_params", "load_hf_checkpoint", "mean_pool_normalize", "pack_rows",
           "rope_tables", "token_chunks"]

#: Most tokens one packed forward takes (262,144: the tokens of the BERT
#: provider's 4,096-row chunk at 64 tokens); longer work is cut into chunks
#: of whole segments (`token_chunks`).
PACK_TOKENS = 1 << 18


@dataclasses.dataclass(frozen=True)
class ModernBertConfig:
    """Architecture hyperparameters (HF modernbert config.json subset)."""

    vocab_size: int = 50368
    hidden_size: int = 768
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    intermediate_size: int = 1152
    max_position_embeddings: int = 8192
    norm_eps: float = 1e-5
    pad_token_id: int = 50283
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    local_attention: int = 128  # window = +/- local_attention // 2
    global_attn_every_n_layers: int = 3
    dtype: str = "bfloat16"

    @staticmethod
    def modernbert_base() -> "ModernBertConfig":
        """ModernBERT-base (768-d, 22 layers)."""
        return ModernBertConfig()

    @staticmethod
    def modernbert_large() -> "ModernBertConfig":
        """ModernBERT-large (1024-d, 28 layers)."""
        return ModernBertConfig(hidden_size=1024, num_hidden_layers=28,
                                num_attention_heads=16, intermediate_size=2624)

    @staticmethod
    def tiny_test() -> "ModernBertConfig":
        """Small config for tests: 4 layers, so both global (0, 3) and local
        (1, 2) layers run."""
        return ModernBertConfig(vocab_size=1024, hidden_size=64,
                                num_hidden_layers=4, num_attention_heads=4,
                                intermediate_size=96,
                                max_position_embeddings=128,
                                local_attention=16, pad_token_id=0,
                                dtype="float32")

    @staticmethod
    def from_json(path: str | Path) -> "ModernBertConfig":
        raw = json.loads(Path(path).read_text())
        d = ModernBertConfig()
        return ModernBertConfig(**{
            f.name: raw.get(f.name, getattr(d, f.name))
            for f in dataclasses.fields(ModernBertConfig) if f.name != "dtype"
        })


def init_params(config: ModernBertConfig, seed: int = 0) -> dict:
    """Random-init parameters in the reference's layout (numpy float32, the
    same seeded draws in the same order). Layer 0's attn_ln_scale slot
    exists but is unused (its attention norm is the identity)."""
    rng = np.random.default_rng(seed)
    h, i, L = config.hidden_size, config.intermediate_size, config.num_hidden_layers

    def w(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    return {
        "embeddings": {
            "word": w(config.vocab_size, h),
            "ln_scale": np.ones((h,), np.float32),
        },
        "layers": {
            "qkv_w": w(L, h, 3 * h),
            "o_w": w(L, h, h),
            "attn_ln_scale": np.ones((L, h), np.float32),
            "wi_w": w(L, h, 2 * i),
            "wo_w": w(L, i, h),
            "mlp_ln_scale": np.ones((L, h), np.float32),
        },
        "final_ln_scale": np.ones((h,), np.float32),
    }


def rope_tables(slen: int, head_dim: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [slen, head_dim] float32 in the duplicated-half layout
    (emb = cat(freqs, freqs)), computed in float64 as the reference does."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.arange(slen, dtype=np.float64)[:, None] * inv_freq[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return np.cos(emb), np.sin(emb)


class ModernBertLayer(nn.Module):
    def __init__(self, config: ModernBertConfig, index: int, dtype: torch.dtype, device):
        super().__init__()
        h, i, eps = config.hidden_size, config.intermediate_size, config.norm_eps
        lin = dict(bias=False, dtype=dtype, device=device)
        f32 = dict(eps=eps, bias=False, dtype=torch.float32, device=device)
        self.heads = config.num_attention_heads
        self.is_global = index % config.global_attn_every_n_layers == 0
        # Layer 0 normalises nothing before attention.
        self.attn_norm = nn.LayerNorm(h, **f32) if index > 0 else None
        self.wqkv = nn.Linear(h, 3 * h, **lin)
        self.wo = nn.Linear(h, h, **lin)
        self.mlp_norm = nn.LayerNorm(h, **f32)
        self.wi = nn.Linear(h, 2 * i, **lin)
        self.mlp_wo = nn.Linear(i, h, **lin)

    def _mlp(self, x):
        wi = self.wi(layer_norm(x, self.mlp_norm))
        inner = wi.shape[-1] // 2
        # GeGLU in float32: the gate half widens inside the product, exactly.
        gated = (F.gelu(wi[..., :inner].float()) * wi[..., inner:]).to(x.dtype)
        return x + self.mlp_wo(gated)

    def forward_packed(self, x, segs: Segments, rope, window: int):
        """x [T, H] packed; rope the (cos, sin) tables [P, D]; `window` the
        local layers' half-width (a global layer ignores it)."""
        t, h = x.shape
        nh = self.heads
        xn = x if self.attn_norm is None else layer_norm(x, self.attn_norm)
        qkv = self.wqkv(xn).view(t, 3, nh, h // nh)
        ctx = varlen_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], segs,
                               None if self.is_global else window, rope=rope)
        x = x + self.wo(ctx.view(t, h))
        return self._mlp(x)


class ModernBertModel(nn.Module):
    """ModernBERT encoder on packed segments: `hidden_packed` gives their
    final hidden states, `forward` the same laid out as a padded batch,
    `pooled` and `pooled_rows` the mean pooled rows of a padded batch or
    token table. Built by `convert.modernbert_from_numpy`."""

    def __init__(self, config: ModernBertConfig, device=None):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        h = config.hidden_size
        f32 = dict(dtype=torch.float32, device=device)
        self.word = nn.Embedding(config.vocab_size, h, **f32)
        self.emb_norm = nn.LayerNorm(h, eps=config.norm_eps, bias=False, **f32)
        self.layers = nn.ModuleList(ModernBertLayer(config, i, self.dtype, device)
                                    for i in range(config.num_hidden_layers))
        self.final_norm = nn.LayerNorm(h, eps=config.norm_eps, bias=False, **f32)
        self._rope: dict = {}

    def _tables(self, slen: int, theta: float, device):
        key = (slen, theta, device)
        if key not in self._rope:
            hd = self.config.hidden_size // self.config.num_attention_heads
            cos, sin = rope_tables(slen, hd, theta)
            self._rope[key] = (torch.from_numpy(cos).to(device),
                               torch.from_numpy(sin).to(device))
        return self._rope[key]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """A padded batch [B, L] (each mask a prefix of ones) -> final hidden
        states [B, L, H] float32: `hidden_packed` on each row's valid tokens,
        zeros at the padding."""
        lens = attention_mask.sum(dim=1).cpu().numpy()
        rows = torch.arange(input_ids.shape[0], device=input_ids.device)
        ids, segs = pack_rows(input_ids, rows, lens)
        out = torch.zeros((*input_ids.shape, self.config.hidden_size), dtype=torch.float32,
                          device=input_ids.device)
        out[segs.segment_ids, segs.positions] = self.hidden_packed(ids, segs)
        return out

    def hidden_packed(self, ids: torch.Tensor, segs: Segments) -> torch.Tensor:
        """Packed ids [T] of the segments `segs` -> final hidden states
        [T, H] float32 (after the final norm)."""
        cfg = self.config
        dev = ids.device
        n_pos = max(cfg.max_position_embeddings, segs.max_len)
        rope = {g: tuple(t.view(n_pos, -1) for t in self._tables(n_pos, theta, dev))
                for g, theta in ((True, cfg.global_rope_theta), (False, cfg.local_rope_theta))}
        x = layer_norm(self.word(ids.long()), self.emb_norm).to(self.dtype)
        for layer in self.layers:
            x = layer.forward_packed(x, segs, rope[layer.is_global], cfg.local_attention // 2)
        return layer_norm(x.float(), self.final_norm)

    def pooled(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """A padded batch [B, L] through `forward_packed`: each row's valid
        tokens (its mask is a prefix of ones) packed end to end -> mean
        pooled rows [B, H] float32 (not normalised)."""
        with region("encoder.pack"):
            lens = attention_mask.sum(dim=1).cpu().numpy()
        rows = torch.arange(input_ids.shape[0], device=input_ids.device)
        return self.pooled_rows(input_ids, rows, lens)

    def pooled_rows(self, table: torch.Tensor, rows: torch.Tensor, lengths) -> torch.Tensor:
        """Rows `rows` of a padded token table [N, L], their first
        `lengths[j]` ids each (host integers), packed and run in chunks of
        whole rows of at most PACK_TOKENS tokens -> mean pooled [n, H]
        float32 (not normalised)."""
        out = torch.empty((rows.numel(), self.config.hidden_size), dtype=torch.float32,
                          device=table.device)
        for s, e in token_chunks(lengths):
            ids, segs = pack_rows(table, rows[s:e], lengths[s:e])
            out[s:e] = forward_packed(self, ids, segs)
        return out


def token_chunks(lengths, budget: int = PACK_TOKENS) -> list[tuple[int, int]]:
    """[start, end) runs of consecutive segments whose tokens sum to at most
    `budget` (a longer segment runs alone)."""
    out, s, acc = [], 0, 0
    for i, n in enumerate(np.asarray(lengths).tolist()):
        if acc and acc + n > budget:
            out.append((s, i))
            s, acc = i, 0
        acc += n
    if s < len(lengths):
        out.append((s, len(lengths)))
    return out


def pack_rows(table: torch.Tensor, rows: torch.Tensor, lengths) -> tuple[torch.Tensor, Segments]:
    """The first `lengths[j]` ids of `table[rows[j]]` ([N, L] padded rows,
    `rows` int on its device, `lengths` on the host), end to end -> (ids
    [T] int32, their Segments). Reads nothing back from the device. Traced
    as the region "encoder.pack"."""
    with region("encoder.pack"):
        segs = Segments.from_lengths(lengths, table.device)
        slen = table.shape[1]
        flat = rows.long()[segs.segment_ids] * slen + segs.positions
        return table.reshape(-1)[flat], segs


def segment_mean(hidden: torch.Tensor, segs: Segments) -> torch.Tensor:
    """Mean of each segment's rows of [T, H] -> [n, H] float32 (an empty
    segment gives zeros). The rows are gathered into a zero-padded
    [n, longest, H] block and summed along it: one fixed order, so the same
    inputs give the same bits."""
    t, h = hidden.shape
    n = segs.count
    if n == 0:
        return hidden.new_zeros((0, h))
    slots = torch.full((n, max(segs.max_len, 1)), t, dtype=torch.int64, device=hidden.device)
    slots[segs.segment_ids, segs.positions] = torch.arange(t, device=hidden.device)
    rows = torch.cat([hidden, hidden.new_zeros((1, h))])[slots]
    lens = torch.from_numpy(np.maximum(segs.lengths, 1)).to(hidden.device, non_blocking=True)
    return rows.sum(dim=1) / lens[:, None]


@torch.inference_mode()
def forward_packed(model: "ModernBertModel", ids: torch.Tensor, segs: Segments) -> torch.Tensor:
    """ModernBERT on packed ids [T] of the segments `segs` -> the mean of
    each segment's final hidden states [n, H] float32 (not normalised).
    Counts its tokens in `forward_packed.tokens_encoded` and, under
    tracing, "encoder.tokens" and "encoder.segments"."""
    if segs.tokens != ids.shape[0]:
        raise ValueError(f"segments hold {segs.tokens} tokens, ids has {ids.shape[0]}")
    count("encoder.tokens", segs.tokens)
    count("encoder.segments", segs.count)
    forward_packed.tokens_encoded += segs.tokens
    return segment_mean(model.hidden_packed(ids, segs), segs)


forward_packed.tokens_encoded = 0


def load_hf_checkpoint(path: str | Path) -> tuple[dict, ModernBertConfig]:
    """Load a ModernBERT checkpoint from a local HF model directory into the
    reference's parameter layout (numpy float32, dense weights [in, out]);
    layer 0's missing attention norm (Identity in HF) fills with ones."""
    path = Path(path)
    config = ModernBertConfig.from_json(path / "config.json")
    raw = {k.removeprefix("model."): v for k, v in read_checkpoint(path).items()}

    def get(name):
        return np.asarray(raw[name], dtype=np.float32)

    ones_h = np.ones((config.hidden_size,), np.float32)

    def stack(fmt: str, transpose: bool) -> np.ndarray:
        mats = []
        for i in range(config.num_hidden_layers):
            key = fmt.format(i=i)
            if key not in raw:  # layer 0 attn_norm is Identity
                mats.append(ones_h)
                continue
            m = get(key)
            mats.append(m.T if transpose else m)
        return np.ascontiguousarray(np.stack(mats))

    params = {
        "embeddings": {
            "word": get("embeddings.tok_embeddings.weight"),
            "ln_scale": get("embeddings.norm.weight"),
        },
        "layers": {
            "qkv_w": stack("layers.{i}.attn.Wqkv.weight", True),
            "o_w": stack("layers.{i}.attn.Wo.weight", True),
            "attn_ln_scale": stack("layers.{i}.attn_norm.weight", False),
            "wi_w": stack("layers.{i}.mlp.Wi.weight", True),
            "wo_w": stack("layers.{i}.mlp.Wo.weight", True),
            "mlp_ln_scale": stack("layers.{i}.mlp_norm.weight", False),
        },
        "final_ln_scale": get("final_norm.weight"),
    }
    return params, config
