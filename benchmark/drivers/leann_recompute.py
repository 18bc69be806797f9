"""Driver for LEANN's recompute search with a BERT encoder as the provider.

Set-up draws a token table of code chunks and a held-out query pool
(prototype chunks with a share of their ids replaced), and the encoder's
weights, all on the device from the seed. The port's `TextEncoder` is made
from those weights; the build makes the centred
`EncoderEmbeddingProvider` and `LeannIndex.build` over it. A call encodes
its query chunks with the port's encoder, centres them as the provider
centres, and runs `LeannIndex.search` with the traffic's knobs; the index
recomputes every exact distance through the provider, whose `embed` runs
inside the harness's span "embed". Counts per call: the gate's recompute
fraction and the query tokens encoded.

The check (after the window, with the program's state freed): the plain
float32 reference encodes the whole corpus and the queries sent, centres
them by its own mean, and gives the exact top-k. Numbers compared:
`query_emb_err`, the widest relative L2 error of the port's query
embeddings (the encoder's pooled output, before the harness centres it);
`row_emb_err`, the same over a seeded sample of the rows the provider
re-encoded in the window, with the provider's centre added back;
`centre_err`, the provider's centre; and on the answers themselves, each
returned distance against the reference's distance of the returned id,
`dist_gap_worst_query`: the largest of the queries' mean gaps over their k
answers, which one wrong answer id lifts far above rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import checks, data, stats
from benchmark.reference import exact, minilm
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.models.bert import BertConfig
from islands_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

CHECK_BLOCK = 8192  # answer rows per block of the distance check
ENCODER_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "max_position_embeddings", "type_vocab_size",
                "layer_norm_eps", "dtype")


class _TimedProvider:
    """The provider the index is handed: `embed` inside the span "embed"
    (waiting for the device at both ends in a traced run, outside its
    profiled slice), and in the window a seeded sample of its rows kept
    for the check."""

    def __init__(self, inner: EncoderEmbeddingProvider, drv: "Driver"):
        self.inner, self.drv = inner, drv

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        d = self.drv
        with d.spans.span("embed", sync=True):
            out = self.inner.embed(ids)
        if d.recording:
            d.embed_calls += 1
            if d.embed_calls % d.sample_every == 0:
                flat = ids.reshape(-1)
                p = int(d.sample_rng.integers(0, flat.numel()))
                d.samples.append((flat[p:p + 1].clone(), out.reshape(-1, out.shape[-1])[p:p + 1].clone()))
        return out


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, spans):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.enc_cfg = cfg["encoder"]
        self.rows = int(cfg["corpus"]["rows"])
        self.k = int(traffic["k"])
        self.search_knobs = dict(traffic["search"])
        self.pool = data.Pool(int(traffic["pool"]), int(traffic["queries_per_call"]), seed, device)
        self.recording = False
        self.sample_every = int(traffic["sample_every"])
        self.sample_rng = np.random.default_rng([int(seed), 0x5A3])
        self.embed_calls = 0
        self.samples: list = []
        self.port_queries: list = []
        h, i, n_l = (int(self.enc_cfg[k]) for k in
                     ("hidden_size", "intermediate_size", "num_hidden_layers"))
        self.info: dict = {"encoder": (h, i, n_l), "seq_len": int(cfg["corpus"]["seq_len"]),
                           "rows": self.rows}

    def make_inputs(self) -> None:
        c = self.cfg["corpus"]
        gen = data.generator(self.seed, self.device)
        lo, hi = int(c["id_lo"]), int(c["id_hi"])
        protos = data.prototypes(gen, int(c["prototypes"]), int(c["seq_len"]), lo, hi)
        args = (float(c["noise"]), lo, hi, int(c["min_len"]))
        self.tok, self.mask = data.token_rows(gen, protos, self.rows, *args)
        self.qtok, self.qmask = data.token_rows(gen, protos, int(self.traffic["pool"]), *args)
        self.qlens = self.qmask.sum(dim=1).cpu().numpy()
        self.info["mean_row_tokens"] = float(self.mask.sum()) / self.rows
        self.gen = gen

    def make_weights(self) -> None:
        e = self.enc_cfg
        self.weights = data.bert_weights(
            self.gen, int(e["vocab_size"]), int(e["hidden_size"]), int(e["num_hidden_layers"]),
            int(e["intermediate_size"]), int(e["max_position_embeddings"]),
            int(e["type_vocab_size"]))
        bc = BertConfig(**{k: e[k] for k in ENCODER_KEYS})
        # Raw pooled outputs: the centred provider skips the L2 norm, and the
        # queries are centred as its rows are.
        self.encoder = TextEncoder(data.to_numpy(self.weights), bc,
                                   config=EncoderConfig(normalize=False), device=self.device)

    def build(self) -> int:
        prov = EncoderEmbeddingProvider(self.encoder, self.tok, self.mask)
        self.provider = prov.with_center(sample=int(self.cfg["centre_rows"]))
        self.timed = _TimedProvider(self.provider, self)
        lc = LeannConfig(metric=DistanceMetric(self.cfg["metric"]), **self.cfg["index"])
        self.index = LeannIndex(lc, device=self.device).build(self.provider, num_vectors=self.rows)
        return self.rows

    def compile(self) -> None:
        """Nothing on this path is built at run time."""

    def next_call(self):
        return self.pool.next()

    def call(self, sel):
        with self.spans.span("encode_query"):
            raw = self.encoder.encode_tokens(self.qtok[sel[1]], self.qmask[sel[1]])
            q = raw - self.provider.center
        with self.spans.span("search"):
            d, ids = self.index.search(q, k=self.k, provider=self.timed, **self.search_knobs)
        frac = self.index.last_recompute_fraction
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        if self.recording:
            self.port_queries.append(raw)
        return d, ids, {"recompute_fraction": frac, "query_tokens": int(self.qlens[sel[0]].sum())}

    def release(self) -> None:
        self.port_queries = torch.cat(self.port_queries).cpu() if self.port_queries else None
        self.samples = [(i.cpu(), r.cpu()) for i, r in self.samples]
        self.port_centre = self.provider.center.cpu()
        self.index = self.provider = self.timed = self.encoder = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------

    def _reference(self, cast=None):
        """Pooled rows of the whole corpus and of the pool's queries, and the
        centre (the mean of the first `centre_rows` rows)."""
        e = self.enc_cfg
        heads, eps = int(e["num_attention_heads"]), float(e["layer_norm_eps"])
        rows = minilm.pooled_blocks(self.weights, self.tok, self.mask, heads, eps, cast=cast)
        centre = rows[:int(self.cfg["centre_rows"])].mean(dim=0)
        queries = minilm.pooled_blocks(self.weights, self.qtok, self.qmask, heads, eps, cast=cast)
        return rows, queries, centre

    def _answer_gap(self, got, ok: np.ndarray, ref) -> float | None:
        """The largest over the well-formed rows of the mean, over the row's
        k answers, of |returned distance - the reference's cosine distance
        of the returned id| (float64, centred by the reference's centre)."""
        rows, queries, centre = ref
        r = np.flatnonzero(ok)
        if len(r) == 0:
            return None
        worst = 0.0
        for s in range(0, len(r), CHECK_BLOCK):
            b = r[s:s + CHECK_BLOCK]
            q = queries[torch.as_tensor(got.pool_idx[b], device=self.device)] - centre
            x = rows[torch.as_tensor(got.ids[b], device=self.device)] - centre
            want = exact.distances64(q, x, exact.COSINE)
            have = torch.as_tensor(got.dists[b], device=self.device).double()
            worst = max(worst, float((have - want).abs().mean(dim=1).max()))
        return worst

    def _numbers(self, got, ok, ref, sample_ids, sample_rows, port_queries, centre) -> dict:
        """The numbers compared, from the reference's (rows, queries, centre)
        and, under judgement, the answers (`ok`: the well-formed rows), the
        sampled rows (raw), the raw queries [Q] in answer order and the
        centre."""
        rows, queries, ref_centre = ref
        qi = torch.as_tensor(got.pool_idx, device=self.device)
        return {"query_emb_err": rel_err(port_queries, queries[qi]),
                "row_emb_err": rel_err(sample_rows, None if sample_ids is None else rows[sample_ids]),
                "centre_err": rel_err(centre[None], ref_centre[None]),
                "dist_gap_worst_query": self._answer_gap(got, ok, ref)}

    def check(self, got, bad: np.ndarray):
        ref = self._reference()
        rows, queries, centre = ref
        used = np.unique(got.pool_idx)
        _, true_ids = exact.exact_topk(queries[torch.as_tensor(used, device=self.device)] - centre,
                                       rows - centre, self.k, exact.COSINE)
        true_ids = true_ids.cpu().numpy()[np.searchsorted(used, got.pool_idx)]
        recall = stats.recall_at_k(got.ids, true_ids)
        port_centre = self.port_centre.to(self.device)
        sample_ids = sample_rows = None
        if self.samples:
            sample_ids = torch.cat([i for i, _ in self.samples]).long().to(self.device)
            sample_rows = torch.cat([r for _, r in self.samples]).to(self.device) + port_centre
        port_q = self.port_queries.to(self.device) if self.port_queries is not None else None
        return recall, self._numbers(got, ~bad, ref, sample_ids, sample_rows, port_q, port_centre)

    def control(self) -> dict:
        """The reference in the program's place at float8 (e4m3, one scale
        per operand): its own top-k of the whole pool, its rows, queries
        and centre, judged as the program's are."""
        ref = self._reference()
        rows8, queries8, centre8 = self._reference(cast=minilm.fp8_e4m3)
        d, ids = exact.exact_topk(queries8 - centre8, rows8 - centre8, self.k, exact.COSINE)
        got = checks.Answers(np.arange(queries8.shape[0]), d.float().cpu().numpy(),
                             ids.cpu().numpy())
        bad = checks.bad_rows(got, self.rows)
        sample = ids.reshape(-1)
        out = self._numbers(got, ~bad, ref, sample, rows8[sample], queries8, centre8)
        return {"bad_answers": int(bad.sum()), **out}


def rel_err(have, want) -> float | None:
    """Widest ||have - want|| / ||want|| over the rows; None without rows."""
    if have is None or want is None or have.shape[0] == 0:
        return None
    if have.shape != want.shape:
        return float("inf")
    num = torch.linalg.vector_norm(have.double() - want.double(), dim=-1)
    return float((num / torch.linalg.vector_norm(want.double(), dim=-1).clamp(min=1e-30)).max())
