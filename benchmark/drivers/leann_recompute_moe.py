"""Driver for LEANN's recompute search with Mellum (a mixture-of-experts decoder) as the provider.

The packed recompute driver (`leann_recompute_packed.py`) with Mellum 2 in
ModernBERT's place: its configuration is the model's config.json keys
(`MellumConfig.from_hf`) beside the corpus and index knobs. Set-up draws
the corpus and the query pool as the packed driver does (`chunk_rows`),
then Mellum's weights on the device from the seed with the driver's own
`mellum_weights`, one layer's tensor at a time, in bf16 (weights
N(0, 0.02^2), RMSNorm scales 1 + N(0, 0.05^2) in float32): never the whole
model in float32, and never on the host. The port's `TextEncoder` and the
reference are handed those same device tensors, with no second copy; the
encoder then encodes two short chunks, so the attention and expert
kernels are compiled before the build. Counts per call, besides the
recompute driver's: the port's `tokens_encoded` counter (every token its
packed forward encoded in the call) and the Mellum FLOPs of the query
chunks; in a traced run also the grouped expert GEMM's and the attention
kernel's least time for the segments handed to the encoder (the query's,
and each `embed` call's rows' from the driver's own length table, each
call one forward), counted by `harness/moe_work.py`.

The check is the recompute driver's, with the plain float32 Mellum of
`reference/mellum.py` (each chunk unpadded, equal lengths batched, each
layer's weights upcast as it runs) in place of the BERT reference.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import leann_recompute as base
from benchmark.drivers import leann_recompute_packed as packed
from benchmark.harness import data, moe_work
from benchmark.reference import mellum as reference
from islands_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from islands_tpu_torch.models.mellum import MellumConfig, forward_packed

WEIGHT_SEED = 0x6D656C6C756D  # added to the run's seed for the weights' generator


def mellum_weights(gen: torch.Generator, cfg: dict, device) -> dict:
    """Mellum's weights drawn on `device` from `gen`, one layer's tensor at a
    time (float32 draws): weights N(0, 0.02^2) stored in the config's
    `dtype` (bf16), RMSNorm scales 1 + N(0, 0.05^2) in float32. The layout the port's
    `models/mellum` takes (dense weights [in, out], layers stacked on axis
    0): `embed` [V, h], `final_norm` [h], and under `layers` `attn_norm`
    [n, h], `qkv_w` [n, h, (nq + 2 nkv) d] (q, k, v columns), `o_w`
    [n, nq d, h], `mlp_norm` [n, h], `router_w` [n, h, E], `gate_up_w`
    [n, E, h, 2i] (gate's columns, then up's), `down_w` [n, E, i, h]."""
    h, n_l, e, i = (int(cfg[k]) for k in ("hidden_size", "num_hidden_layers", "num_experts",
                                           "moe_intermediate_size"))
    qw = int(cfg["num_attention_heads"]) * int(cfg["head_dim"])
    kvw = int(cfg["num_key_value_heads"]) * int(cfg["head_dim"])
    shapes = {
        (None, "embed"): (int(cfg["vocab_size"]), h),
        ("layers", "attn_norm"): (n_l, h),
        ("layers", "qkv_w"): (n_l, h, qw + 2 * kvw),
        ("layers", "o_w"): (n_l, qw, h),
        ("layers", "mlp_norm"): (n_l, h),
        ("layers", "router_w"): (n_l, h, e),
        ("layers", "gate_up_w"): (n_l, e, h, 2 * i),
        ("layers", "down_w"): (n_l, e, i, h),
        (None, "final_norm"): (h,),
    }
    dtype = getattr(torch, str(cfg.get("dtype", "bfloat16")))
    out: dict = {"layers": {}}
    for (group, name), shape in shapes.items():
        norm = name.endswith("norm")
        t = torch.empty(shape, dtype=torch.float32 if norm else dtype, device=device)
        for part in (t if group == "layers" else t[None]):
            draw = torch.randn(part.shape, generator=gen, device=device)
            part.copy_(draw * 0.05 + 1.0 if norm else draw * 0.02)
        (out["layers"] if group == "layers" else out)[name] = t
    return out


class Driver(packed.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, spans):
        self.mc = MellumConfig.from_hf(cfg)
        enc = {"hidden_size": self.mc.hidden_size,
               "intermediate_size": self.mc.moe_intermediate_size,
               "num_hidden_layers": self.mc.num_hidden_layers}
        base.Driver.__init__(self, dict(cfg, encoder=enc), traffic, seed, device, spans)
        self.widths = moe_work.Widths.from_config(cfg)
        self.embedded: list = []

    def make_inputs(self) -> None:
        c = self.cfg["corpus"]
        gen = data.generator(self.seed, self.device)
        lo, hi = int(c["id_lo"]), int(c["id_hi"])
        protos = data.prototypes(gen, int(c["prototypes"]), int(c["seq_len"]), lo, hi)
        args = (float(c["noise"]), lo, hi, int(c["min_len"]))
        self.tok, self.mask, self.row_lens = packed.chunk_rows(gen, protos, self.rows, *args)
        self.qtok, self.qmask, self.qlens = packed.chunk_rows(
            gen, protos, int(self.traffic["pool"]), *args)
        self.info["mean_row_tokens"] = float(self.row_lens.mean())
        self.info["mellum_row_flops_mean"] = float(
            moe_work.segment_flops(self.row_lens, self.widths).mean())

    def make_weights(self) -> None:
        # The weights' own generator, seeded apart from the inputs' (the
        # run's seed plus a constant): drawn on the device, one layer's
        # tensor at a time.
        gen = data.generator((self.seed + WEIGHT_SEED) % 2**63, self.device)
        self.weights = mellum_weights(gen, self.cfg, self.device)
        # Raw pooled outputs: the centred provider skips the L2 norm, and the
        # queries are centred as its rows are.
        self.encoder = TextEncoder(self.weights, self.mc, config=EncoderConfig(normalize=False),
                                   device=self.device)
        # The kernels compile at their first launch: launch them here, at a
        # token count that is a multiple of 16 and one that is not, so that
        # the build's time holds no compile.
        for n in (16, 17):
            ids = self.qtok[:1, :n]
            self.encoder.encode_tokens(ids, torch.ones_like(ids))

    def call(self, sel):
        before = forward_packed.tokens_encoded
        self.embedded = []
        d, ids, counts = base.Driver.call(self, sel)
        qlens = self.qlens[sel[0]]
        counts["tokens_encoded"] = forward_packed.tokens_encoded - before
        counts["query_flops"] = float(moe_work.segment_flops(qlens, self.widths).sum())
        if self.counting:
            experts = moe_work.experts_bound_s(int(qlens.sum()), self.widths)
            attn = moe_work.attention_bound_s(qlens, self.widths)
            for rows in self.embedded:
                lens = self.row_lens[np.clip(rows.cpu().numpy(), 0, self.rows - 1)]
                experts += moe_work.experts_bound_s(int(lens.sum()), self.widths)
                attn += moe_work.attention_bound_s(lens, self.widths)
            counts["moe_bound_s"] = experts
            counts["attn_bound_s"] = attn
        self.embedded = []
        return d, ids, counts

    def _reference(self, cast=None):
        """Pooled rows of the whole corpus and of the pool's queries, and the
        centre (the mean of the first `centre_rows` rows)."""
        rows = reference.pooled_rows(self.weights, self.cfg, self.tok, self.row_lens, cast=cast)
        centre = rows[:int(self.cfg["centre_rows"])].mean(dim=0)
        queries = reference.pooled_rows(self.weights, self.cfg, self.qtok, self.qlens,
                                        cast=cast)
        return rows, queries, centre
