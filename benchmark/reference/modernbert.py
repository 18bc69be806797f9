"""A plain ModernBERT encoder forward (answerdotai/ModernBERT-base's architecture) in float32.

Written from the published model (Warner et al., arXiv:2412.13663) as
HuggingFace transformers' `ModernBertModel` computes it:

- embeddings: the token embedding, then LayerNorm without a bias (eps
  `norm_eps`); no position embeddings;
- each layer: `attn_norm` (the identity at layer 0), `Wqkv` without a bias,
  rotary position embeddings on q and k (rotate-half; theta
  `global_rope_theta` on the global layers, every
  `global_attn_every_n_layers`-th from layer 0, and `local_rope_theta` on
  the others; the cos and sin tables computed in float32 from float32
  inverse frequencies, as HF's rotary embedding computes them), softmax
  attention scaled by 1/sqrt(head size) over the whole segment (global)
  or over the keys with |i - j| <= local_attention // 2 (local), `Wo`,
  the residual; `mlp_norm`, `Wi` split into (input, gate), exact-erf
  GELU(input) x gate, `Wo`, the residual;
- `final_norm`.

Departures from HF's model, none of them in the arithmetic of a token:
- the sentence embedding is the mean of each segment's final hidden states
  (not normalised): mean pooling is the deployment's choice, not the
  checkpoint's (`ModernBertModel` returns the hidden states);
- each segment runs alone and unpadded (HF's own unpadded path), so no
  padding mask exists; segments of one length run together as a batch of at
  most `budget` tokens;
- a local layer computes its band in blocks: each block of 128 queries
  against the 128 + 2 w keys around it, positions outside the segment or
  the band set to -1e30 before the softmax (the same keys as the dense
  band mask);
- weights are the benchmark's own, in the layout of the port's
  `init_params` (dense weights [in, out]): `embeddings.word` [V, h],
  `embeddings.ln_scale` [h], `layers.qkv_w` [n, h, 3h], `layers.o_w`
  [n, h, h], `layers.attn_ln_scale` [n, h] (layer 0's unused),
  `layers.wi_w` [n, h, 2i], `layers.wo_w` [n, i, h], `layers.mlp_ln_scale`
  [n, h], `final_ln_scale` [h].

Every product runs in float32 with TF32 off. `cast`, when given, is
applied to every operand of every product: the control's lower precision
(`minilm.fp8_e4m3`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.exact import full_f32

BAND_BLOCK = 128  # queries per block of a local layer's band
GROUP_TOKENS = 32768  # tokens per batch of equal-length segments


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _ln(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w


def rope(slen: int, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [slen, head_dim] float32 (rotate-half layout)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim))
    freqs = torch.arange(slen, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _band(q, k, v, w: int, mm) -> torch.Tensor:
    """Softmax attention of q over k, v [b, H, s, d] within |i - j| <= w,
    in blocks of BAND_BLOCK queries."""
    b, nh, s, d = q.shape
    blk = BAND_BLOCK
    nb = -(-s // blk)
    tail = nb * blk - s
    qb = F.pad(q, (0, 0, 0, tail)).view(b, nh, nb, blk, d)
    kw = F.pad(k, (0, 0, w, tail + w)).unfold(2, blk + 2 * w, blk)  # [b, H, nb, d, blk + 2w]
    vw = F.pad(v, (0, 0, w, tail + w)).unfold(2, blk + 2 * w, blk)
    qpos = torch.arange(nb * blk, device=q.device).view(nb, blk)
    kpos = (torch.arange(nb, device=q.device)[:, None] * blk - w
            + torch.arange(blk + 2 * w, device=q.device)[None, :])
    ok = ((kpos >= 0) & (kpos < s))[:, None, :] & \
        ((qpos[:, :, None] - kpos[:, None, :]).abs() <= w)
    scores = mm(qb, kw) / math.sqrt(d)
    # -1e30, not -inf: the padding queries past the segment, which see no
    # key, get finite weights (and are cut off), so no NaN reaches `cast`.
    p = torch.softmax(scores.masked_fill(~ok, -1e30), dim=-1)
    out = mm(p, vw.transpose(-1, -2))  # [b, H, nb, blk, d]
    return out.reshape(b, nh, nb * blk, d)[:, :, :s]


@torch.no_grad()
def hidden(weights: dict, cfg: dict, ids: torch.Tensor, cast=None) -> torch.Tensor:
    """ids [b, s], every row a whole segment of s tokens -> final hidden
    states [b, s, h] float32."""
    full_f32()
    cast = cast or _ident
    emb, lay = weights["embeddings"], weights["layers"]
    b, slen = ids.shape
    h = emb["word"].shape[1]
    nh = int(cfg["num_attention_heads"])
    hd, eps = h // nh, float(cfg["norm_eps"])
    w = int(cfg["local_attention"]) // 2
    every = int(cfg["global_attn_every_n_layers"])
    tables = {g: rope(slen, hd, float(cfg[key]), ids.device)
              for g, key in ((True, "global_rope_theta"), (False, "local_rope_theta"))}

    def mm(a, m):
        return cast(a) @ cast(m)

    x = _ln(emb["word"][ids.long()], emb["ln_scale"], eps)
    for i in range(lay["qkv_w"].shape[0]):
        is_global = i % every == 0
        xn = x if i == 0 else _ln(x, lay["attn_ln_scale"][i], eps)
        qkv = mm(xn, lay["qkv_w"][i])
        q, k, v = (qkv[..., j * h:(j + 1) * h].reshape(b, slen, nh, hd).transpose(1, 2)
                   for j in range(3))
        cos, sin = tables[is_global]
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if is_global:
            p = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
            ctx = mm(p, v)
        else:
            ctx = _band(q, k, v, w, mm)
        x = x + mm(ctx.transpose(1, 2).reshape(b, slen, h), lay["o_w"][i])
        wi = mm(_ln(x, lay["mlp_ln_scale"][i], eps), lay["wi_w"][i])
        inp, gate = wi[..., :wi.shape[-1] // 2], wi[..., wi.shape[-1] // 2:]
        x = x + mm(F.gelu(inp) * gate, lay["wo_w"][i])
    return _ln(x, weights["final_ln_scale"], eps)


def pooled(weights: dict, cfg: dict, ids: torch.Tensor, cast=None) -> torch.Tensor:
    """ids [b, s] -> the mean of each row's final hidden states [b, h]."""
    return hidden(weights, cfg, ids, cast).mean(dim=1)


def pooled_rows(weights: dict, cfg: dict, table: torch.Tensor, lengths, cast=None,
                budget: int = GROUP_TOKENS) -> torch.Tensor:
    """Rows of a padded token table [N, L] whose first `lengths[r]` ids are
    row r's segment -> [N, h] float32, one batch of equal-length rows at a
    time (rows of length 0 give zeros)."""
    lens = np.asarray(lengths, dtype=np.int64)
    out = torch.zeros((table.shape[0], weights["embeddings"]["word"].shape[1]),
                      dtype=torch.float32, device=table.device)
    for s in np.unique(lens[lens > 0]).tolist():
        rows = np.flatnonzero(lens == s)
        per = max(1, budget // s)
        for a in range(0, rows.shape[0], per):
            r = torch.as_tensor(rows[a:a + per], device=table.device)
            out[r] = pooled(weights, cfg, table[r, :s], cast)
    return out
