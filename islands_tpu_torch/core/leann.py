"""LEANN index: graph-only storage, recompute search and two-level PQ gating.

Port of islands_tpu/core/leann.py. Build a proximity graph from an embedding
provider (or an [n, d] tensor), train PQ on the same vectors, drop the
embeddings, and answer queries by recomputing embeddings through the
provider:
- `search`: the recompute search, either every unpruned neighbour of a hop
  scored exactly (gate "none", with the configured pruning strategy) or the
  sketch gate (only the promoted candidates are recomputed);
- `search_two_level`: PQ-ADC gated beam search (core/search.py
  `batched_two_level_search`; kernels K2 and, with hop_merge="fused", K1);
- `search_pq_scan`: a full ADC scan that keeps each query's best `rerank`
  candidates (kernel K3's "smallest" route), then an exact rerank.
`extend` appends items by insertion waves (build.extend_graph), the
incremental re-index of a repository sync.

Runs on CUDA unless `device="cpu"`; results are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.build import build_index_with_sketch, extend_graph, sample_levels
from islands_tpu_torch.core.config import LeannConfig, PQConfig
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.embedding import EmbeddingProvider, materialize_embeddings
from islands_tpu_torch.core.pq import (
    ProductQuantizer,
    build_inline_codes,
    gated_block_scorer_for,
    gated_prep_for,
    pq_scan_smallest,
)
from islands_tpu_torch.core.search import (
    HOP_GRAPHS_KEPT,
    batched_search,
    batched_sketch_gated_query,
    batched_two_level_search,
    default_max_iters,
    make_prune_fn,
    make_recompute_scorer,
    route_entries_embed,
)
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.ops.merge import smallest_k
from islands_tpu_torch.utils.graphs import GraphCache
from islands_tpu_torch.utils.tracing import count, region, traced


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
        # On CUDA the sketch gate replays its hops as CUDA graphs, two a hop
        # around the provider's eager `embed`.
        self._hop_graphs = GraphCache(kept=HOP_GRAPHS_KEPT) if self.device.type == "cuda" else None

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
        self._graph_replaced()
        if with_pq is not None:
            self._train_pq(x, with_pq)

    def extend(self, provider: EmbeddingProvider,
               num_total: int | None = None) -> "LeannIndex":
        """Append items [num_nodes, num_total) from `provider`, which must
        cover ALL items: every embedding is recomputed for the append and
        dropped after. New levels draw from seed + n_old; the sketch (same
        projection, scale refit over the whole corpus) and the PQ codes are
        rederived for all items."""
        n_total = num_total if num_total is not None else provider.num_items
        graph = self._require_graph()
        n_old = graph.num_nodes
        if n_total <= n_old:
            return self
        if n_old == 0:
            return self.build(provider, n_total)
        cfg = self.config
        x_all = dist_ops.prep_corpus(
            to_device(materialize_embeddings(provider, n_total), self.device, torch.float32),
            cfg.metric)
        neighbors, degrees = extend_graph(graph.neighbors, graph.degrees, x_all, n_old, cfg,
                                          graph.entry_point)
        levels = np.concatenate([
            graph.levels.cpu().numpy(),
            sample_levels(n_total - n_old, cfg.ml, cfg.max_layers, cfg.seed + n_old)])
        max_level = int(levels.max())
        self.graph = CsrGraph(neighbors=neighbors, degrees=degrees,
                              levels=to_device(levels, self.device),
                              entry_point=int(np.argmax(levels == max_level)),
                              max_level=max_level)
        if self.sketch is not None:
            # The reference redraws the projection from the seed, which is
            # the build's own; keeping the sketch's `w` is the same for an
            # index built here and keeps the projection of one carried over.
            self.sketch = proj_ops.build_sketch_index(
                x_all, self.graph.neighbors, proj_dims=self.sketch.proj_dims,
                seed=cfg.seed, w=self.sketch.w)
        self._graph_replaced()
        if self.pq is not None:
            self.pq_codes = self.pq.encode(x_all)
        return self

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

    def _graph_replaced(self) -> None:
        """After a build or an extend: new routing ids, and a new cache of
        hop graphs (the old graphs hold the old neighbours' and sketch's
        pointers), with the same capture."""
        self._tl_routing = {}
        self._init_routing()
        if self._hop_graphs is not None:
            self._hop_graphs = GraphCache(self._hop_graphs.capture, HOP_GRAPHS_KEPT)

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

    @traced("leann.search")
    def search(self, queries, k: int, provider: EmbeddingProvider, ef: int | None = None,
               expand_width: int | None = None, max_iters: int | None = None,
               gate: str = "auto", promote_width: int | None = None):
        """Recompute search: queries [B, d] (or [d]) -> (dists [B, k],
        ids [B, k]) ascending; unfilled slots (+inf, -1).

        `gate`: "none" scores every unpruned neighbour of each hop through
        the provider (the configured pruning strategy and prune_ratio decide
        which); "sketch" ranks each hop's neighbours by their inline sketches
        and recomputes only the `promote_width` best per hop, and sets
        `last_recompute_fraction`; "auto" takes the sketch gate when the index
        has a sketch and `config.sketch_query` is set. `promote_width` and
        `max_iters` default to the config's `promote_width` and
        `max_search_iters`, then to the gate's own formula.

        On a CUDA index the sketch gate replays each hop as two CUDA graphs,
        captured on the first call of a shape and kept by the index: the
        provider's `embed` runs eagerly between them, once a hop, as on the
        eager route, so its host reads and the caller's wrappers see every
        hop (`core/search._SplitHopGraph`). Routing, the entry scores and
        the end stay eager; gate "none" runs eagerly throughout.

        Traced (utils/tracing) as the root region "leann.search"; the sketch
        gate counts "search.exact_rows", the rows it scored exactly (the sum
        of its per-query counts, read with the recompute fraction), and
        "search.hop.graphed", its replayed hops."""
        graph = self._require_graph()
        q, single = self._queries(queries)
        if self.is_empty:
            b = q.shape[0]
            d = torch.zeros((b, 0), dtype=torch.float32, device=self.device)
            ids = torch.zeros((b, 0), dtype=torch.int32, device=self.device)
            return (d[0], ids[0]) if single else (d, ids)
        cfg = self.config
        ef = max(ef if ef is not None else cfg.ef_search, k)
        expand_width = expand_width or cfg.expand_width
        if promote_width is None:
            promote_width = cfg.promote_width
        if max_iters is None:
            max_iters = cfg.max_search_iters
        scorer = make_recompute_scorer(cfg.metric)
        qp = dist_ops.prep_query(q, cfg.metric)
        if gate == "auto":
            gate = "sketch" if (self.sketch is not None and cfg.sketch_query) else "none"
        if gate == "sketch":
            if self.sketch is None:
                raise IndexNotBuilt("no SketchIndex (built with sketch_build=False)")
            qs = proj_ops.sketch_query(qp, self.sketch.w, self.sketch.scale)
            promote = promote_width or max(8, min(2 * expand_width * 4, ef))
            if max_iters is None:
                max_iters = 8 * max(ef // promote, 1) + 32
            dists, ids, n_exact = batched_sketch_gated_query(
                qp, qs, provider.embed, self.sketch.scale, graph.neighbors,
                self.sketch.nbr_sketch, self.sketch.node_sketch, self._routing,
                exact_scorer=scorer, metric=cfg.metric, dim=int(qp.shape[1]), ef=ef, k=k,
                aq_width=max(ef, 64), promote_width=promote, expand_width=expand_width,
                max_iters=max_iters, hop_graphs=self._hop_graphs)
            n_exact = n_exact.cpu()  # the search's one read of its counts
            count("search.exact_rows", int(n_exact.sum()))
            self.last_recompute_fraction = (float(n_exact.float().mean())
                                            / max(self.num_nodes, 1))
            return (dists[0], ids[0]) if single else (dists, ids)
        if gate != "none":
            raise ValueError(f"unknown gate {gate!r}: 'auto', 'sketch' or 'none'")
        if max_iters is None:
            max_iters = default_max_iters(ef, expand_width)
        prune = make_prune_fn(cfg.pruning_strategy, cfg.prune_ratio, ef, seed=cfg.seed)
        dists, ids = batched_search(qp, provider.embed, graph.neighbors, graph.entry_point,
                                    graph.degrees, scorer=scorer, ef=ef,
                                    expand_width=expand_width, max_iters=max_iters,
                                    prune_fn=prune)
        dists, ids = dists[:, :k], ids[:, :k]
        return (dists[0], ids[0]) if single else (dists, ids)

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

        exact = make_recompute_scorer(cfg.metric)
        qp = dist_ops.prep_query(q, cfg.metric)
        entries = graph.entry_point
        if routing_size is not None and routing_size > 0:
            with region("search.route"):
                entries = route_entries_embed(q, provider.embed,
                                              self._routing_sample(routing_size), cfg.metric)
        dists, ids, n_exact = batched_two_level_search(
            qp, provider.embed, self._inline_codes(), self.pq.codebook.centroids,
            graph.neighbors, entries,
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
        """Graph-free search: ADC-scan ALL codes and take the `rerank` best
        approximate candidates (lower id first on ties; kernel K3's
        "smallest" route, which writes no [B, N] distances),
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

        # lax.top_k(-pq_scan(...), rerank)
        cand = pq_scan_smallest(self.pq, q, self.pq_codes, rerank, metric=self.config.metric)
        scorer = make_recompute_scorer(self.config.metric)
        qp = dist_ops.prep_query(q, self.config.metric)
        d_exact = scorer(provider.embed, qp, cand, torch.ones_like(cand, dtype=torch.bool))
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
