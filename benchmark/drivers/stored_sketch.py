"""Driver for a stored-vector index queried through the sketch gate.

Builds `core/build.build_index_with_sketch` over a seeded Gaussian mixture
and serves `core/search.StoredSearcher.search` with the traffic's knobs.
A call sends `queries_per_call` queries of the pool and ends with the
answers on the host. Counts per call: hops (one fused hop-merge launch, K1,
per hop of the gated loop).

The check: the reference's exact top-k of every pool query sent, for
recall; and each returned distance against the float64 distance of the
returned id (`dist_rel_err`, the widest relative gap).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import checks, data, stats
from benchmark.reference import exact
from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.ops import _cuda
from islands_tpu_torch.ops.hop_merge import hop_merge

CHECK_BLOCK = 65536  # answers per block of the float64 distance check


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, spans):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.metric = cfg["metric"]
        self.rows = int(cfg["corpus"]["rows"])
        self.k = int(traffic["k"])
        self.search_knobs = dict(traffic["search"])
        self.recording = False
        self.pool = data.Pool(int(traffic["pool"]), int(traffic["queries_per_call"]), seed, device)
        self.info: dict = {}

    def make_inputs(self) -> None:
        c = self.cfg["corpus"]
        gen = data.generator(self.seed, self.device)
        self.x, self.queries = data.gaussian_mixture(gen, self.rows, int(c["dim"]), int(c["centres"]),
                                                     float(c["sigma"]), int(self.traffic["pool"]))

    def make_weights(self) -> None:
        """A stored index has no weights."""

    def build(self) -> int:
        lc = LeannConfig(metric=DistanceMetric(self.metric), **self.cfg["index"])
        graph, sketch = build_index_with_sketch(self.x, lc, device=self.device)
        self.searcher = StoredSearcher(graph, self.x, lc.metric, sketch=sketch,
                                       routing_size=int(self.cfg["routing_size"]),
                                       device=self.device)
        b, kn = int(self.traffic["queries_per_call"]), self.search_knobs
        self.info["hop_merge_shape"] = (b, int(kn["expand_width"]) * int(graph.neighbors.shape[1]),
                                        max(int(kn["ef"]), 64), int(kn["promote_width"]))
        return self.rows

    def compile(self) -> None:
        """The fused hop-merge's library (nvcc, the first run in a checkout)."""
        if self.device.type == "cuda" and self.search_knobs.get("hop_merge") == "fused":
            _cuda.build("hop_merge")

    def next_call(self):
        return self.pool.next()

    def call(self, sel):
        before = hop_merge.launches
        with self.spans.span("search"):
            d, ids = self.searcher.search(self.queries[sel[1]], k=self.k, **self.search_knobs)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        return d, ids, {"hops": hop_merge.launches - before}

    def release(self) -> None:
        self.searcher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, got, bad: np.ndarray):
        used = np.unique(got.pool_idx)
        q_used = self.queries[torch.as_tensor(used, device=self.device)]
        _, true_ids = exact.exact_topk(q_used, self.x, self.k, self.metric)
        true_ids = true_ids.cpu().numpy()[np.searchsorted(used, got.pool_idx)]
        recall = stats.recall_at_k(got.ids, true_ids)
        return recall, {"dist_rel_err": self.dist_rel_err(got, ~bad)}

    def dist_rel_err(self, got, ok: np.ndarray) -> float:
        """Widest |returned - float64| / float64 over the well-formed rows."""
        worst = 0.0
        rows = np.flatnonzero(ok)
        for s in range(0, len(rows), CHECK_BLOCK):
            r = rows[s:s + CHECK_BLOCK]
            q = self.queries[torch.as_tensor(got.pool_idx[r], device=self.device)]
            ids = torch.as_tensor(got.ids[r], device=self.device)
            want = exact.distances64(q, self.x[ids], self.metric)
            have = torch.as_tensor(got.dists[r], device=self.device).double()
            worst = max(worst, float(((have - want).abs() / want.clamp(min=1e-12)).max()))
        return worst

    def control(self) -> dict:
        """The reference in the program's place at TF32: its answers to the
        whole pool, judged as the program's are."""
        d, ids = exact.tf32_topk(self.queries, self.x, self.k, self.metric)
        got = checks.Answers(np.arange(self.queries.shape[0]), d.cpu().numpy(), ids.cpu().numpy())
        bad = checks.bad_rows(got, self.rows)
        return {"bad_answers": int(bad.sum()), "dist_rel_err": self.dist_rel_err(got, ~bad)}
