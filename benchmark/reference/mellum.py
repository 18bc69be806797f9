"""A plain Mellum 2 forward (JetBrains/Mellum2-12B-A2.5B's architecture) in float32.

Written from the published config.json
(https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct) as HF
transformers computes a decoder of its kind (Mistral/Qwen-MoE family):

- x = the token embedding;
- each layer: RMSNorm (float32, eps `rms_norm_eps`), q, k, v projections
  without biases (32 query heads, 4 key/value heads of `head_dim` 128;
  each key/value head repeated for its 8 query heads), rotary position
  embeddings on q and k (rotate-half; "sliding_attention" layers plain
  RoPE of `rope_theta`, "full_attention" layers YaRN: HF's
  `_compute_yarn_parameters` with the correction range floored and
  ceiled, the linear ramp blending the interpolated (/ factor) and
  extrapolated frequencies, cos and sin multiplied by `attention_factor`;
  tables computed in float32 from float32 inverse frequencies), causal
  softmax attention scaled by 1/sqrt(head_dim), a sliding layer keeping
  only keys with i - j < `sliding_window`, the o projection, the residual;
  RMSNorm, the router (no bias) and its softmax over the `num_experts`
  logits, the top `num_experts_per_tok` renormalised to sum to 1
  (`norm_topk_prob`), each chosen expert's SwiGLU down(silu(gate(y)) *
  up(y)) weighted and summed, the residual;
- a final RMSNorm; the sentence embedding is each segment's last token's
  final hidden state (not normalised).

Departures from HF's model, none of them in the arithmetic of a token:
- the LM and multi-token-prediction heads are left out: an embedder pools
  hidden states (the deployment's choice, as e5-mistral, arXiv:2401.00368);
- each segment runs alone and unpadded, so no padding mask exists;
  segments of one length run together as a batch, and batches of up to
  `budget` tokens together a layer at a time;
- each expert runs on the rows routed to it (a gather and `torch.mm`),
  not on every token; masked keys get -1e30 before the softmax;
- weights are the benchmark's own, in the layout of the port's
  `mellum.init_params` (dense weights [in, out], layers stacked on axis 0):
  `embed` [V, h], `layers.attn_norm` [n, h], `layers.qkv_w` [n, h, (32 +
  2 x 4) x 128] (q, k, v columns), `layers.o_w` [n, 4096, h],
  `layers.mlp_norm` [n, h], `layers.router_w` [n, h, E],
  `layers.gate_up_w` [n, E, h, 2i] (gate's columns, then up's),
  `layers.down_w` [n, E, i, h],
  `final_norm` [h]. Each layer's weights are upcast to float32 as it runs
  (1.7 GB at the published widths), never the whole model at once.

The largest batch of equal-length rows at the cell's widths is 42 rows of
192 tokens: [42, 32, 192, 192] float32 scores, 0.2 GB; a run of
131,072 tokens holds its residual stream and its experts' rows (~1.2 GB
each).

Every product runs in float32 with TF32 off. `cast`, when given, is
applied to every operand of every product (the router's too): the
control's lower precision (`minilm.fp8_e4m3`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.exact import full_f32

GROUP_TOKENS = 131072  # tokens a run of batches takes through the layers together
SLIDING, FULL = "sliding_attention", "full_attention"


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def inv_freq(cfg: dict, kind: str) -> tuple[torch.Tensor, float]:
    """Inverse frequencies [head_dim / 2] float32 and the cos/sin scale of a
    layer type, from the config's `rope_parameters`."""
    p = cfg["rope_parameters"][kind]
    dim, base = int(cfg["head_dim"]), float(p["rope_theta"])
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if p.get("rope_type", "default") == "default":
        return 1.0 / pos_freqs, 1.0
    if p["rope_type"] != "yarn":
        raise ValueError(f"no reference for rope_type {p['rope_type']!r}")
    factor = float(p["factor"])
    orig = float(p["original_max_position_embeddings"])
    scale = p.get("attention_factor")
    scale = 0.1 * math.log(factor) + 1.0 if scale is None else float(scale)

    def corr(rot: float) -> float:
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(float(p.get("beta_fast") or 32))), 0)
    high = min(math.ceil(corr(float(p.get("beta_slow") or 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    keep = 1 - ramp  # the share of each frequency left unscaled (extrapolated)
    return (1.0 / (factor * pos_freqs)) * (1 - keep) + (1.0 / pos_freqs) * keep, scale


def rope(cfg: dict, kind: str, slen: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [slen, head_dim] float32 (rotate-half layout)."""
    inv, scale = inv_freq(cfg, kind)
    freqs = torch.arange(slen, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1).to(device)
    return emb.cos() * scale, emb.sin() * scale


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _experts(y: torch.Tensor, lw: dict, cfg: dict, mm) -> torch.Tensor:
    """The sparse MLP of y [n, h] -> [n, h]: router softmax, top k
    renormalised, each expert on the rows routed to it."""
    k = int(cfg["num_experts_per_tok"])
    probs = torch.softmax(mm(y, lw["router_w"]), dim=-1)
    w, e = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    flat = e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=lw["router_w"].shape[1]).tolist()
    tok, wt = order // k, w.reshape(-1)[order]
    out = torch.zeros_like(y)
    i = lw["down_w"].shape[1]
    s = 0
    for ex, c in enumerate(counts):
        if c:
            t = tok[s:s + c]
            rows = y[t]
            gate_up = lw["gate_up_w"][ex]
            mid = F.silu(mm(rows, gate_up[:, :i])) * mm(rows, gate_up[:, i:])
            out.index_add_(0, t, mm(mid, lw["down_w"][ex]) * wt[s:s + c, None])
        s += c
    return out


def _attention(x: torch.Tensor, lw: dict, cfg: dict, kind: str, mm) -> torch.Tensor:
    """One layer's attention block of x [b, s, h] (every row a whole
    segment) -> its output [b, s, h], before the residual."""
    b, slen, _ = x.shape
    nq, nkv, d = (int(cfg[k]) for k in ("num_attention_heads", "num_key_value_heads",
                                         "head_dim"))
    qkv = mm(_rms(x, lw["attn_norm"], float(cfg["rms_norm_eps"])), lw["qkv_w"])
    q = qkv[..., :nq * d].reshape(b, slen, nq, d).transpose(1, 2)
    k = qkv[..., nq * d:(nq + nkv) * d].reshape(b, slen, nkv, d).transpose(1, 2)
    v = qkv[..., (nq + nkv) * d:].reshape(b, slen, nkv, d).transpose(1, 2)
    cos, sin = rope(cfg, kind, slen, x.device)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    k, v = k.repeat_interleave(nq // nkv, dim=1), v.repeat_interleave(nq // nkv, dim=1)
    pos = torch.arange(slen, device=x.device)
    gap = pos[:, None] - pos[None, :]
    keep = gap >= 0 if kind == FULL else (gap >= 0) & (gap < int(cfg["sliding_window"]))
    p = torch.softmax((mm(q, k.transpose(-1, -2)) / math.sqrt(d)).masked_fill(~keep, -1e30),
                      dim=-1)
    return mm(mm(p, v).transpose(1, 2).reshape(b, slen, nq * d), lw["o_w"])


@torch.no_grad()
def _forward(weights: dict, cfg: dict, groups: list, cast=None) -> list:
    """Batches ids [b, s] (every row a whole segment of s tokens) -> their
    final hidden states [b, s, h] float32, all batches a layer at a time:
    each layer's weights are upcast once, and its experts run on the rows
    all the batches route to them."""
    full_f32()
    cast = cast or _ident

    def mm(a, m):
        return cast(a) @ cast(m)

    eps = float(cfg["rms_norm_eps"])
    xs = [weights["embed"][ids.long()].float() for ids in groups]
    for i, kind in enumerate(cfg["layer_types"]):
        lw = {name: t[i].float() for name, t in weights["layers"].items()}
        xs = [x + _attention(x, lw, cfg, kind, mm) for x in xs]
        flat = torch.cat([_rms(x, lw["mlp_norm"], eps).reshape(-1, x.shape[-1]) for x in xs])
        out = _experts(flat, lw, cfg, mm)
        del flat, lw
        at = 0
        for j, x in enumerate(xs):
            n = x.shape[0] * x.shape[1]
            xs[j] = x + out[at:at + n].view_as(x)
            at += n
        del out
    return [_rms(x, weights["final_norm"].float(), eps) for x in xs]


def hidden(weights: dict, cfg: dict, ids: torch.Tensor, cast=None) -> torch.Tensor:
    """ids [b, s], every row a whole segment of s tokens -> final hidden
    states [b, s, h] float32."""
    return _forward(weights, cfg, [ids], cast)[0]


def pooled(weights: dict, cfg: dict, ids: torch.Tensor, cast=None) -> torch.Tensor:
    """ids [b, s] -> each row's last token's final hidden state [b, h]."""
    return hidden(weights, cfg, ids, cast)[:, -1]


def pooled_rows(weights: dict, cfg: dict, table: torch.Tensor, lengths, cast=None,
                budget: int = GROUP_TOKENS) -> torch.Tensor:
    """Rows of a padded token table [N, L] whose first `lengths[r]` ids are
    row r's segment -> [N, h] float32 (rows of length 0 give zeros). Rows
    of one length run as one batch; batches run together, a layer at a
    time, up to `budget` tokens."""
    lens = np.asarray(lengths, dtype=np.int64)
    out = torch.zeros((table.shape[0], weights["embed"].shape[1]), dtype=torch.float32,
                      device=table.device)
    batches = [(np.flatnonzero(lens == s), s) for s in np.unique(lens[lens > 0]).tolist()]
    run, tokens = [], 0
    for b, (rows, s) in enumerate(batches):
        run.append((torch.as_tensor(rows, device=table.device), s))
        tokens += rows.shape[0] * s
        if tokens >= budget or b == len(batches) - 1:
            for (r, _), h in zip(run, _forward(weights, cfg, [table[r, :n] for r, n in run],
                                               cast)):
                out[r] = h[:, -1]
            run, tokens = [], 0
    return out
