"""Inputs and weights, made on the device from the run's seed.

Every draw comes from one `torch.Generator` on the run's device, in a few
large calls. The same seed gives the same inputs on the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def gaussian_mixture(gen: torch.Generator, n: int, dim: int, centres: int, sigma: float,
                     n_queries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py's corpus: overlapping Gaussian clusters (centres ~ N(0, I),
    each row a centre plus sigma-scaled noise), and queries drawn alike."""
    dev = gen.device
    c = torch.randn((centres, dim), generator=gen, device=dev)
    x = c[torch.randint(0, centres, (n,), generator=gen, device=dev)]
    x += sigma * torch.randn((n, dim), generator=gen, device=dev)
    q = c[torch.randint(0, centres, (n_queries,), generator=gen, device=dev)]
    q += sigma * torch.randn((n_queries, dim), generator=gen, device=dev)
    return x, q


def token_rows(gen: torch.Generator, protos: torch.Tensor, n: int, noise: float,
               id_lo: int, id_hi: int, min_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n chunks of token ids [n, L] and their masks: each a prototype's ids
    with a `noise` share replaced by fresh ids in [id_lo, id_hi), padded
    (id 0) past a length in [min_len, L]. The lengths are the same multiset
    for every seed (as even over the range as n allows), in a seeded order."""
    dev = gen.device
    slen = protos.shape[1]
    ids = protos[torch.randint(0, protos.shape[0], (n,), generator=gen, device=dev)]
    fresh = torch.randint(id_lo, id_hi, (n, slen), generator=gen, device=dev)
    ids = torch.where(torch.rand((n, slen), generator=gen, device=dev) < noise, fresh, ids)
    span = slen - min_len + 1
    lens = min_len + torch.arange(n, device=dev) % span
    lens = lens[torch.randperm(n, generator=gen, device=dev)]
    mask = torch.arange(slen, device=dev)[None, :] < lens[:, None]
    return (ids * mask).to(torch.int32), mask.to(torch.int32)


def prototypes(gen: torch.Generator, count: int, slen: int, id_lo: int,
               id_hi: int) -> torch.Tensor:
    return torch.randint(id_lo, id_hi, (count, slen), generator=gen, device=gen.device)


def bert_weights(gen: torch.Generator, vocab: int, hidden: int, layers: int,
                 intermediate: int, positions: int, type_vocab: int) -> dict:
    """Float32 BERT weights in the layout of the port's `init_params`
    (dense weights [in, out], q/k/v fused, layers stacked on axis 0), drawn
    in one call: weights and biases ~ N(0, 0.02^2), LayerNorm scales
    1 + N(0, 0.05^2) and shifts ~ N(0, 0.02^2), so every parameter counts."""
    h, i, n_l = hidden, intermediate, layers
    shapes = {
        ("embeddings", "word"): (vocab, h), ("embeddings", "position"): (positions, h),
        ("embeddings", "token_type"): (type_vocab, h),
        ("embeddings", "ln_scale"): (h,), ("embeddings", "ln_bias"): (h,),
        ("layers", "qkv_w"): (n_l, h, 3 * h), ("layers", "qkv_b"): (n_l, 3 * h),
        ("layers", "o_w"): (n_l, h, h), ("layers", "o_b"): (n_l, h),
        ("layers", "attn_ln_scale"): (n_l, h), ("layers", "attn_ln_bias"): (n_l, h),
        ("layers", "ffn_in_w"): (n_l, h, i), ("layers", "ffn_in_b"): (n_l, i),
        ("layers", "ffn_out_w"): (n_l, i, h), ("layers", "ffn_out_b"): (n_l, h),
        ("layers", "ffn_ln_scale"): (n_l, h), ("layers", "ffn_ln_bias"): (n_l, h),
    }
    total = sum(torch.Size(s).numel() for s in shapes.values())
    flat = torch.randn((total,), generator=gen, device=gen.device)
    out: dict = {"embeddings": {}, "layers": {}}
    pos = 0
    for (group, name), shape in shapes.items():
        size = torch.Size(shape).numel()
        t = flat[pos:pos + size].view(shape)
        pos += size
        out[group][name] = t * 0.05 + 1.0 if name.endswith("ln_scale") else t * 0.02
    return out


def to_numpy(weights: dict) -> dict:
    """The same weights as host float32 arrays (what the port's encoder
    constructor takes)."""
    return {g: {k: v.detach().cpu().numpy() for k, v in d.items()} for g, d in weights.items()}


class Pool:
    """The order in which a traffic's pool of queries is sent: each pass is
    a fresh seeded permutation of the whole pool, cut into calls of `batch`
    queries, so no call repeats until the pool runs out."""

    def __init__(self, size: int, batch: int, seed: int, device):
        if size % batch:
            raise ValueError(f"pool {size} is not a multiple of the batch {batch}")
        self.size, self.batch, self.device = size, batch, device
        self.rng = np.random.default_rng([int(seed), 0x9E37])
        self.pos = size

    def next(self):
        """(pool indices on the host [batch], the same on the device)."""
        if self.pos == self.size:
            self.host = self.rng.permutation(self.size)
            self.dev = torch.as_tensor(self.host, device=self.device)
            self.pos = 0
        s = slice(self.pos, self.pos + self.batch)
        self.pos += self.batch
        return self.host[s], self.dev[s]
