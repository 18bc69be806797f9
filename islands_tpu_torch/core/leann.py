"""LEANN index: graph-only storage, recompute search and two-level PQ gating.

Port of islands_tpu/core/leann.py. Build a proximity graph from an embedding
provider (or an [n, d] tensor), train PQ on the same vectors, drop the
embeddings, and answer queries by recomputing embeddings through the
provider:
- `search_two_level`: PQ-ADC gated beam search (core/search.py
  `batched_two_level_search`; kernels K2 and, with hop_merge="fused", K1);
- `search_pq_scan`: a full ADC scan (kernel K3), then an exact rerank.
The plain recompute search `search` (the recompute gate with pruning) and
`extend` are not ported yet and raise NotImplementedError.

Runs on CUDA unless `device="cpu"`; results are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import LeannConfig, PQConfig
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.embedding import EmbeddingProvider, materialize_embeddings
from islands_tpu_torch.core.pq import (
    ProductQuantizer,
    build_inline_codes,
    gated_block_scorer_for,
    gated_prep_for,
    pq_scan,
)
from islands_tpu_torch.core.search import (
    batched_two_level_search,
    make_recompute_scorer,
    route_entries_embed,
)
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops.merge import smallest_k


class IndexNotBuilt(RuntimeError):
    """Search before build, or a search that needs what the build skipped."""


class DimensionMismatch(ValueError):
    """Query/provider dimension mismatch."""


class LeannIndex:
    """Graph-only ANN index with on-the-fly embedding recomputation: after a
    build only the graph, the PQ codebook and codes, and the sketch table
    persist; no [n, d] float matrix."""

    def __init__(self, config: LeannConfig | None = None, device=None):
        self.config = config or LeannConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self.graph: CsrGraph | None = None
        self.dimension: int | None = None
        self.pq: ProductQuantizer | None = None
        self.pq_codes: torch.Tensor | None = None
        self.sketch = None  # ops/proj.SketchIndex from construction
        self.last_recompute_fraction: float | None = None
        self._routing: torch.Tensor | None = None
        self._tl_routing: dict[int, torch.Tensor] = {}
        # Inline neighbour-code blocks [N, m0*S] uint8 for the two-level hop,
        # derived from (graph, codes) and cached on the identity of both.
        self._nbr_codes: torch.Tensor | None = None
        self._nbr_codes_key = None

    # -- introspection -----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes if self.graph is not None else 0

    @property
    def is_empty(self) -> bool:
        return self.num_nodes == 0

    def storage_bytes(self) -> int:
        """Graph + PQ (codes and codebook) + sketch table bytes: the 'index
        bytes/vector' metric. The inline neighbour blocks are derived at
        search time and not counted."""
        total = self.graph.storage_bytes() if self.graph is not None else 0
        if self.pq is not None and self.pq_codes is not None:
            total += self.pq.storage_bytes(self.num_nodes)
        if self.sketch is not None:
            total += 4 * self.sketch.node_sketch.numel() + 4 * self.sketch.w.numel() + 4
        return total

    # -- build ---------------------------------------------------------------

    def build(self, provider: EmbeddingProvider, num_vectors: int | None = None,
              with_pq: PQConfig | None = None) -> "LeannIndex":
        """Build from `provider`'s first `num_vectors` embeddings, which are
        materialized only for construction and PQ training."""
        n = num_vectors if num_vectors is not None else provider.num_items
        self.dimension = provider.dimension
        if n == 0:
            self.graph = CsrGraph.empty(0, self.config.m0, self.device)
            return self
        x = to_device(materialize_embeddings(provider, n), self.device, torch.float32)
        self._build(x, with_pq)
        return self

    def build_from_embeddings(self, x, with_pq: PQConfig | None = None) -> "LeannIndex":
        """Build from an [n, d] array or tensor."""
        x = to_device(x, self.device, torch.float32)
        self.dimension = int(x.shape[1]) if x.dim() == 2 else None
        self._build(x, with_pq)
        return self

    def _build(self, x: torch.Tensor, with_pq: PQConfig | None) -> None:
        self.graph, self.sketch = build_index_with_sketch(x, self.config, device=self.device)
        self._tl_routing = {}
        self._init_routing()
        if with_pq is not None:
            self._train_pq(x, with_pq)

    def extend(self, provider: EmbeddingProvider, num_total: int | None = None):
        raise NotImplementedError(
            "LeannIndex.extend (build.extend_graph) is not ported yet; see ROADMAP.md")

    def _inline_codes(self) -> torch.Tensor:
        """Inline neighbour-code blocks, rebuilt when the graph or the codes
        change (keyed on the tensors' identity, not their shapes: a rebuild
        at the same n swaps both)."""
        key = (self.graph.neighbors, self.pq_codes)
        if self._nbr_codes_key is None or not (
                self._nbr_codes_key[0] is key[0] and self._nbr_codes_key[1] is key[1]):
            self._nbr_codes = build_inline_codes(self.graph.neighbors, self.pq_codes)
            self._nbr_codes_key = key
        return self._nbr_codes

    def _routing_sample(self, routing_size: int) -> torch.Tensor:
        """Seeded routing ids for the two-level path (cached per size); a
        numpy draw, so they equal the reference's."""
        n = self.num_nodes
        size = min(routing_size, n)
        if size not in self._tl_routing:
            rng = np.random.default_rng(self.config.seed)
            self._tl_routing[size] = torch.as_tensor(
                rng.integers(0, n, size=size), dtype=torch.int32, device=self.device)
        return self._tl_routing[size]

    def _init_routing(self) -> None:
        """Routing ids of the sketch gate (used by `search`)."""
        n = self.num_nodes
        if self.sketch is not None and n > 0:
            rng = np.random.default_rng(self.config.seed)
            self._routing = torch.as_tensor(
                rng.integers(0, n, size=min(self.config.routing_size, n)),
                dtype=torch.int32, device=self.device)

    def _train_pq(self, x: torch.Tensor, pq_config: PQConfig) -> None:
        """Train PQ and encode all vectors, on prep_corpus(x): for COSINE the
        normalized vectors, so inner-product tables approximate cosine."""
        xt = dist_ops.prep_corpus(x, self.config.metric)
        self.pq = ProductQuantizer(pq_config, device=self.device)
        self.pq.train(xt)
        self.pq_codes = self.pq.encode(xt)

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, provider: EmbeddingProvider, **kwargs):
        raise NotImplementedError(
            "LeannIndex.search (the recompute gate with pruning) is not ported yet; "
            "see ROADMAP.md queue 1 item 8")

    def _queries(self, queries) -> tuple[torch.Tensor, bool]:
        q = to_device(queries, self.device, torch.float32)
        single = q.dim() == 1
        if single:
            q = q[None, :]
        self._check_dim(q.shape[1])
        return q, single

    def search_two_level(self, queries, k: int, provider: EmbeddingProvider,
                         ef: int | None = None, rerank_ratio: float = 0.1,
                         expand_width: int | None = None, aq_width: int | None = None,
                         promote_width: int | None = None, max_iters: int | None = None,
                         end_rerank: bool = False, routing_size: int | None = None,
                         static_loop: bool | None = None, adc_impl: str = "grouped",
                         final_rescore: int = 0, hop_merge: str = "inline"):
        """Two-level search: the PQ-ADC approximate queue gates which
        candidates are scored exactly through `provider`. queries [B, d] (or
        [d]) -> (dists [B, k], ids [B, k]) ascending. Sets
        `last_recompute_fraction` = mean exact scores per query / num_nodes.

        `end_rerank=True` hops pure-ADC and rescores the ef pool once at the
        end. `routing_size=R` starts each query at the nearest of R sampled
        nodes by exact distance. `static_loop` runs exactly `max_iters`
        hops. `adc_impl` is "grouped" (kernel K2) or "einsum" (its plain
        version). `final_rescore=F` rescores the AQ's best F once after the
        loop. `hop_merge` is "inline" or "fused" (kernel K1)."""
        graph = self._require_graph()
        if self.pq is None or self.pq_codes is None:
            raise IndexNotBuilt("two-level search requires PQ (build with with_pq=)")
        q, single = self._queries(queries)
        cfg = self.config
        ef = max(ef if ef is not None else cfg.ef_search, k)
        expand_width = expand_width or cfg.expand_width
        if aq_width is None:
            aq_width = max(ef, 64)
        if promote_width is None:
            promote_width = cfg.promote_width
        if max_iters is None:
            max_iters = cfg.max_search_iters
        if promote_width is None:
            promote_width = max(1, round(rerank_ratio * aq_width))
        promote_width = min(promote_width, expand_width * graph.max_degree)
        if max_iters is None:
            max_iters = 8 * max(ef // max(promote_width, 1), 1) + 32

        exact = make_recompute_scorer(provider.embed, cfg.metric)
        qp = dist_ops.prep_query(q, cfg.metric)
        entries = graph.entry_point
        if routing_size is not None and routing_size > 0:
            entries = route_entries_embed(q, provider.embed,
                                          self._routing_sample(routing_size), cfg.metric)
        dists, ids, n_exact = batched_two_level_search(
            qp, self._inline_codes(), self.pq.codebook.centroids, graph.neighbors, entries,
            exact_scorer=exact, approx_scorer=gated_block_scorer_for(cfg.metric, adc_impl),
            prep_fn=gated_prep_for(cfg.metric), ef=ef, aq_width=aq_width,
            promote_width=promote_width, expand_width=expand_width, max_iters=max_iters,
            promote_exact=not end_rerank, static_iters=bool(static_loop),
            final_rescore=final_rescore, hop_merge=hop_merge)
        self.last_recompute_fraction = (float(n_exact.float().mean())
                                        / max(self.num_nodes, 1))
        dists, ids = dists[:, :k], ids[:, :k]
        return (dists[0], ids[0]) if single else (dists, ids)

    def search_pq_scan(self, queries, k: int, provider: EmbeddingProvider,
                       rerank: int | None = None):
        """Graph-free search: ADC-scan ALL codes (kernel K3), take the
        `rerank` best approximate candidates (lower id first on ties),
        score them exactly through `provider`, return the top k. Pads with
        (+inf, -1) when the corpus is smaller than k."""
        self._require_graph()
        if self.pq is None or self.pq_codes is None:
            raise IndexNotBuilt("PQ scan requires PQ (build with with_pq=)")
        q, single = self._queries(queries)
        rerank = rerank or max(4 * k, 32)
        # At least k candidates are reranked, and no more exist than nodes.
        rerank = min(max(rerank, k), self.num_nodes)
        k_eff = min(k, rerank)

        d_approx = pq_scan(self.pq, q, self.pq_codes, metric=self.config.metric)
        cand = smallest_k(d_approx, rerank)  # lax.top_k(-d, rerank)
        del d_approx
        scorer = make_recompute_scorer(provider.embed, self.config.metric)
        qp = dist_ops.prep_query(q, self.config.metric)
        d_exact = scorer(qp, cand, torch.ones_like(cand, dtype=torch.bool))
        pos = smallest_k(d_exact, k_eff)
        dists = d_exact.gather(1, pos)
        ids = cand.gather(1, pos).to(torch.int32)
        self.last_recompute_fraction = rerank / max(self.num_nodes, 1)
        if k_eff < k:
            dists = torch.nn.functional.pad(dists, (0, k - k_eff), value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
        return (dists[0], ids[0]) if single else (dists, ids)

    # -- helpers -----------------------------------------------------------

    def _require_graph(self) -> CsrGraph:
        if self.graph is None:
            raise IndexNotBuilt("index is not built")
        return self.graph

    def _check_dim(self, d: int) -> None:
        if self.dimension is not None and d != self.dimension:
            raise DimensionMismatch(f"expected dimension {self.dimension}, got {d}")
