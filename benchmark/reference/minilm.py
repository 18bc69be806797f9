"""A plain BERT encoder forward (all-MiniLM-L6-v2's architecture) in float32.

Written from the published BERT description: token + position + type-0
embeddings, LayerNorm, then per layer fused q/k/v, scaled dot-product
attention over the unpadded keys, output projection, residual and
LayerNorm, exact-erf GELU feed-forward, residual and LayerNorm; the
sentence embedding is the mean of the unpadded tokens' last hidden states
(not normalised). Every product runs in float32 with TF32 off. Padded keys
get an additive -1e9 before the softmax.

Weights are the benchmark's own, in `harness.data.bert_weights`' layout.
`cast`, when given, is applied to every operand of every product: the
control's lower precision (`fp8_e4m3`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.exact import full_f32


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale for the whole tensor (its
    largest magnitude onto the format's 448), back in float32."""
    scale = torch.clamp(t.abs().amax(), min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


@torch.no_grad()
def pooled(weights: dict, ids: torch.Tensor, mask: torch.Tensor, heads: int,
           eps: float = 1e-12, cast=None) -> torch.Tensor:
    """ids, mask [B, L] -> mean-pooled last hidden states [B, h] float32."""
    full_f32()
    cast = cast or _ident
    emb, lay = weights["embeddings"], weights["layers"]
    b, slen = ids.shape
    h = emb["word"].shape[1]
    hd = h // heads

    def mm(a, w):
        return cast(a) @ cast(w)

    x = emb["word"][ids.long()] + emb["position"][:slen][None] + emb["token_type"][0]
    x = _ln(x, emb["ln_scale"], emb["ln_bias"], eps)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
    for i in range(lay["qkv_w"].shape[0]):
        qkv = mm(x, lay["qkv_w"][i]) + lay["qkv_b"][i]
        q, k, v = (qkv[..., j * h:(j + 1) * h].reshape(b, slen, heads, hd).transpose(1, 2)
                   for j in range(3))
        p = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias, dim=-1)
        ctx = mm(p, v).transpose(1, 2).reshape(b, slen, h)
        x = _ln(x + mm(ctx, lay["o_w"][i]) + lay["o_b"][i],
                lay["attn_ln_scale"][i], lay["attn_ln_bias"][i], eps)
        ff = mm(F.gelu(mm(x, lay["ffn_in_w"][i]) + lay["ffn_in_b"][i]), lay["ffn_out_w"][i])
        x = _ln(x + ff + lay["ffn_out_b"][i], lay["ffn_ln_scale"][i], lay["ffn_ln_bias"][i], eps)
    m = mask.to(torch.float32)[:, :, None]
    return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1e-9)


def pooled_blocks(weights: dict, ids: torch.Tensor, mask: torch.Tensor, heads: int,
                  eps: float = 1e-12, block: int = 2048, cast=None) -> torch.Tensor:
    """`pooled` over the rows in blocks, so the activations fit."""
    return torch.cat([pooled(weights, ids[s:s + block], mask[s:s + block], heads, eps, cast)
                      for s in range(0, ids.shape[0], block)])
