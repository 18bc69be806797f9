"""Driver for LEANN's recompute search with ModernBERT, unpadded, as the provider.

The recompute driver (`leann_recompute.py`) with ModernBERT in BERT's
place and code chunks of many lengths. Set-up draws, on the device from
the seed, a token table of code chunks padded to `seq_len` and a held-out
query pool (prototype chunks with a share of their ids replaced, each cut
to a length from a log-uniform multiset on [min_len, seq_len] that is the
same for every seed), and ModernBERT's weights; it then encodes two short
chunks, so the attention kernels are compiled before the build. The
port's `TextEncoder` over those weights runs ModernBERT's packed forward:
the provider packs the valid tokens of the rows it re-encodes, the encoder
the query's own. Counts per call, besides the recompute driver's: the
port's `tokens_encoded` counter (every token its packed forward encoded in
the call) and the ModernBERT FLOPs of the query chunks; in a traced run
also the attention kernel's least time for the segments handed to the
encoder (the query's, and each `embed` call's rows' from the driver's own
length table), counted by `harness/modernbert_work.py`.

The check is the recompute driver's, with the plain float32 ModernBERT of
`reference/modernbert.py` (each chunk unpadded, equal lengths batched) in
place of the BERT reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.drivers import leann_recompute as base
from benchmark.harness import data, modernbert_work
from benchmark.reference import modernbert as reference
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from islands_tpu_torch.models.modernbert import ModernBertConfig, forward_packed
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

MODEL_KEYS = tuple(f.name for f in dataclasses.fields(ModernBertConfig))


def chunk_rows(gen: torch.Generator, protos: torch.Tensor, n: int, noise: float, id_lo: int,
               id_hi: int, min_len: int) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """n chunks [n, L] drawn as `data.token_rows` draws them, cut to
    log-uniform lengths in [min_len, L] in a seeded order: (ids padded with
    0, masks, the lengths on the host)."""
    dev = gen.device
    slen = protos.shape[1]
    ids = protos[torch.randint(0, protos.shape[0], (n,), generator=gen, device=dev)]
    fresh = torch.randint(id_lo, id_hi, (n, slen), generator=gen, device=dev)
    ids = torch.where(torch.rand((n, slen), generator=gen, device=dev) < noise, fresh, ids)
    lens = torch.as_tensor(modernbert_work.log_uniform_lengths(n, min_len, slen), device=dev)
    lens = lens[torch.randperm(n, generator=gen, device=dev)]
    mask = torch.arange(slen, device=dev)[None, :] < lens[:, None]
    return (ids * mask).to(torch.int32), mask.to(torch.int32), lens.cpu().numpy()


def modernbert_weights(gen: torch.Generator, vocab: int, hidden: int, layers: int,
                       intermediate: int) -> dict:
    """Float32 ModernBERT weights in the layout of the port's `init_params`
    (dense weights [in, out], layers stacked on axis 0), drawn in one call:
    weights ~ N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.05^2)."""
    h, i, n_l = hidden, intermediate, layers
    shapes = {
        ("embeddings", "word"): (vocab, h), ("embeddings", "ln_scale"): (h,),
        ("layers", "qkv_w"): (n_l, h, 3 * h), ("layers", "o_w"): (n_l, h, h),
        ("layers", "attn_ln_scale"): (n_l, h), ("layers", "wi_w"): (n_l, h, 2 * i),
        ("layers", "wo_w"): (n_l, i, h), ("layers", "mlp_ln_scale"): (n_l, h),
        (None, "final_ln_scale"): (h,),
    }
    flat = torch.randn((sum(torch.Size(s).numel() for s in shapes.values()),), generator=gen,
                       device=gen.device)
    out: dict = {"embeddings": {}, "layers": {}}
    pos = 0
    for (group, name), shape in shapes.items():
        size = torch.Size(shape).numel()
        t = flat[pos:pos + size].view(shape)
        pos += size
        t = t * 0.05 + 1.0 if name.endswith("ln_scale") else t * 0.02
        (out if group is None else out[group])[name] = t
    return out


def _numpy(weights: dict) -> dict:
    return {g: ({k: v.cpu().numpy() for k, v in d.items()} if isinstance(d, dict)
                else d.cpu().numpy()) for g, d in weights.items()}


class _CountingProvider(base._TimedProvider):
    """The recompute driver's timed provider; in a traced run it also keeps
    the ids of every `embed` call for the attention work count."""

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        if self.drv.counting:
            self.drv.embedded.append(ids.reshape(-1))
        return super().embed(ids)


class Driver(base.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, spans):
        super().__init__(cfg, traffic, seed, device, spans)
        self.widths = modernbert_work.Widths.from_config(self.enc_cfg)
        self.embedded: list = []

    @property
    def counting(self) -> bool:
        return self.spans.traced and self.recording

    def make_inputs(self) -> None:
        c = self.cfg["corpus"]
        gen = data.generator(self.seed, self.device)
        lo, hi = int(c["id_lo"]), int(c["id_hi"])
        protos = data.prototypes(gen, int(c["prototypes"]), int(c["seq_len"]), lo, hi)
        args = (float(c["noise"]), lo, hi, int(c["min_len"]))
        self.tok, self.mask, self.row_lens = chunk_rows(gen, protos, self.rows, *args)
        self.qtok, self.qmask, self.qlens = chunk_rows(gen, protos, int(self.traffic["pool"]),
                                                       *args)
        self.info["mean_row_tokens"] = float(self.row_lens.mean())
        self.info["mb_row_flops_mean"] = float(
            modernbert_work.segment_flops(self.row_lens, self.widths).mean())
        self.gen = gen

    def make_weights(self) -> None:
        e = self.enc_cfg
        self.weights = modernbert_weights(self.gen, int(e["vocab_size"]), int(e["hidden_size"]),
                                          int(e["num_hidden_layers"]),
                                          int(e["intermediate_size"]))
        mc = ModernBertConfig(**{k: e[k] for k in MODEL_KEYS})
        # Raw pooled outputs: the centred provider skips the L2 norm, and the
        # queries are centred as its rows are.
        self.encoder = TextEncoder(_numpy(self.weights), mc,
                                   config=EncoderConfig(normalize=False), device=self.device)
        # The attention kernels compile at their first launch: launch them
        # here, at a token count that is a multiple of 16 and one that is
        # not, so that the build's time holds no compile.
        for n in (16, 17):
            ids = self.qtok[:1, :n]
            self.encoder.encode_tokens(ids, torch.ones_like(ids))

    def build(self) -> int:
        prov = EncoderEmbeddingProvider(self.encoder, self.tok, self.mask)
        self.provider = prov.with_center(sample=int(self.cfg["centre_rows"]))
        self.timed = _CountingProvider(self.provider, self)
        lc = LeannConfig(metric=DistanceMetric(self.cfg["metric"]), **self.cfg["index"])
        self.index = LeannIndex(lc, device=self.device).build(self.provider, num_vectors=self.rows)
        return self.rows

    def call(self, sel):
        before = forward_packed.tokens_encoded
        self.embedded = []
        d, ids, counts = super().call(sel)
        qlens = self.qlens[sel[0]]
        counts["tokens_encoded"] = forward_packed.tokens_encoded - before
        counts["query_flops"] = float(modernbert_work.segment_flops(qlens, self.widths).sum())
        if self.counting:
            bound = modernbert_work.attention_bound_s(qlens, self.widths)
            for rows in self.embedded:
                r = np.clip(rows.cpu().numpy(), 0, self.rows - 1)
                bound += modernbert_work.attention_bound_s(self.row_lens[r], self.widths)
            counts["attn_bound_s"] = bound
        self.embedded = []
        return d, ids, counts

    def _reference(self, cast=None):
        """Pooled rows of the whole corpus and of the pool's queries, and the
        centre (the mean of the first `centre_rows` rows)."""
        rows = reference.pooled_rows(self.weights, self.enc_cfg, self.tok, self.row_lens,
                                     cast=cast)
        centre = rows[:int(self.cfg["centre_rows"])].mean(dim=0)
        queries = reference.pooled_rows(self.weights, self.enc_cfg, self.qtok, self.qlens,
                                        cast=cast)
        return rows, queries, centre
