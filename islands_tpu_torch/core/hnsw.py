"""Multi-layer HNSW index with stored embeddings.

Port of islands_tpu/core/hnsw.py. Each layer is a padded neighbour matrix
over the (compacted) subset of nodes reaching that layer, built by the wave
pipeline (core/build.py); upper layers hold about n / m^l nodes. A search
walks every query greedily down the upper layers (`_greedy_descend`, a
batched loop in which a query stops moving once no neighbour improves it)
and runs the batched layer-0 beam (core/search.batched_search) from each
query's own entry point. `extend` appends vectors by insertion waves against
layer 0 (build.extend_graph) and rebuilds the small upper layers.

Runs on CUDA unless `device="cpu"`; results are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.build import build_index, extend_graph, sample_levels
from islands_tpu_torch.core.config import DistanceMetric, HnswConfig
from islands_tpu_torch.core.csr import SENTINEL, CsrGraph
from islands_tpu_torch.core.search import batched_search, default_max_iters, make_stored_scorer
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops

_INF = float("inf")


def _greedy_descend(q: torch.Tensor, neighbors: torch.Tensor, x_local: torch.Tensor,
                    cur: torch.Tensor, metric: DistanceMetric,
                    max_hops: int = 64) -> torch.Tensor:
    """Move each query's cursor to its best neighbour until none improves
    (an ef = 1 search of one layer). q [B, d] prepped, cur [B] local ids ->
    [B] local ids. A query that does not improve keeps its cursor, and so
    never moves again; the loop ends when no query moved, or after
    `max_hops`. argmin takes the first minimum, as jnp.argmin does."""
    n = neighbors.shape[0]
    ones = torch.ones((cur.shape[0], 1), dtype=torch.bool, device=cur.device)

    def score(ids, valid):
        rows = x_local[torch.clamp(ids, 0, n - 1).long()]
        return torch.where(valid, dist_ops.rowwise_distance(q, rows, metric), _INF)

    cur_d = score(cur[:, None], ones)[:, 0]
    for _ in range(max_hops):
        rows = neighbors[torch.clamp(cur, 0, n - 1).long()]  # [B, m]
        d = score(rows, rows != SENTINEL)
        best, best_j = torch.min(d, dim=1)
        best_id = rows.gather(1, best_j[:, None])[:, 0]
        better = best < cur_d
        if not bool(better.any()):
            break
        cur = torch.where(better, best_id, cur)
        cur_d = torch.where(better, best, cur_d)
    return cur


class HnswLayer:
    """One upper layer of a corpus x [N, d]: the global ids of its nodes
    (`ids`, host) and their local-id neighbour matrix, with the layer's
    prepped embeddings, its ids and the global -> local map (`g2l_dev`,
    SENTINEL where absent) on the device for the search."""

    def __init__(self, ids: np.ndarray, neighbors: torch.Tensor, x: torch.Tensor):
        self.ids = ids
        self.neighbors = neighbors
        dev = neighbors.device
        self.ids_dev = torch.as_tensor(ids, dtype=torch.int32, device=dev)
        self.x_local = x[self.ids_dev.long()]
        self.g2l_dev = torch.full((x.shape[0],), SENTINEL, dtype=torch.int32, device=dev)
        self.g2l_dev[self.ids_dev.long()] = torch.arange(len(ids), dtype=torch.int32,
                                                         device=dev)


class HnswIndex:
    """Multi-layer HNSW over stored (prepped) embeddings."""

    def __init__(self, config: HnswConfig | None = None, device=None):
        self.config = config or HnswConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self.x: torch.Tensor | None = None  # prepped corpus [N, d]
        self.levels: np.ndarray | None = None
        self.layers: list[HnswLayer] = []  # upper layers, layer 1 first
        self.layer0: CsrGraph | None = None
        self.entry_point: int = SENTINEL
        self.max_level: int = 0
        self.dimension: int | None = None

    @property
    def num_nodes(self) -> int:
        return 0 if self.x is None else self.x.shape[0]

    @property
    def is_empty(self) -> bool:
        return self.num_nodes == 0

    def get_vector(self, node_id: int) -> torch.Tensor:
        """The stored (prepped) vector of a node."""
        return self.x[node_id]

    # -- build --------------------------------------------------------------

    def build(self, x, levels: np.ndarray | None = None) -> "HnswIndex":
        """Build every layer from embeddings [N, d]."""
        x = to_device(x, self.device, torch.float32)
        n = int(x.shape[0])
        self.dimension = int(x.shape[1]) if x.dim() == 2 else None
        self.x = dist_ops.prep_corpus(x, self.config.metric)
        if n == 0:
            self.levels = np.zeros(0, dtype=np.int32)
            self.layer0 = CsrGraph.empty(0, self.config.m0, self.device)
            self.layers = []
            self.entry_point = SENTINEL
            return self
        if levels is None:
            levels = sample_levels(n, self.config.ml, self.config.max_layers, self.config.seed)
        self.levels = np.asarray(levels, dtype=np.int32)
        self.max_level = int(self.levels.max())
        self.entry_point = int(np.argmax(self.levels == self.max_level))
        # Layer 0: a flat build of the whole corpus (levels all zero, so the
        # sub-build keeps no hierarchy of its own).
        self.layer0 = build_index(self.x, self.config.to_leann(0),
                                  levels=np.zeros(n, dtype=np.int32), device=self.device)
        self._build_upper_layers()
        return self

    def _build_upper_layers(self) -> None:
        self.layers = [self._build_layer(np.where(self.levels >= lvl)[0].astype(np.int32), lvl)
                       for lvl in range(1, self.max_level + 1)]

    def _build_layer(self, ids: np.ndarray, lvl: int) -> HnswLayer:
        cfg = self.config.to_leann(lvl)
        if len(ids) <= 1:
            nbrs = torch.full((len(ids), cfg.m0), SENTINEL, dtype=torch.int32,
                              device=self.device)
            return HnswLayer(ids, nbrs, self.x)
        x_l = self.x[torch.as_tensor(ids, device=self.device).long()]
        g = build_index(x_l, cfg, levels=np.zeros(len(ids), dtype=np.int32), device=self.device)
        return HnswLayer(ids, g.neighbors, self.x)

    def extend(self, new_x) -> "HnswIndex":
        """Append vectors: insertion waves against the existing layer-0
        graph; the upper layers are rebuilt."""
        new_x = to_device(new_x, self.device, torch.float32)
        if self.is_empty:
            return self.build(new_x)
        n_old = self.num_nodes
        n_new = int(new_x.shape[0])
        if n_new == 0:
            return self
        cfg0 = self.config.to_leann(0)
        x_all = torch.cat([self.x, dist_ops.prep_corpus(new_x, self.config.metric)])
        new_levels = sample_levels(n_new, self.config.ml, self.config.max_layers,
                                   self.config.seed + n_old)
        self.levels = np.concatenate([self.levels, new_levels])
        neighbors, degrees = extend_graph(self.layer0.neighbors, self.layer0.degrees, x_all,
                                          n_old, cfg0, self.entry_point)
        self.x = x_all
        self.max_level = int(self.levels.max())
        self.entry_point = int(np.argmax(self.levels == self.max_level))
        self.layer0 = CsrGraph(neighbors=neighbors, degrees=degrees,
                               levels=to_device(self.levels, self.device),
                               entry_point=self.entry_point, max_level=self.max_level)
        self._build_upper_layers()
        return self

    # -- search -------------------------------------------------------------

    def search(self, queries, k: int = 10, ef: int = 100, expand_width: int = 4,
               max_iters: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Greedy descent through the upper layers, then the ef beam at
        layer 0. queries [B, d] or [d] -> (dists, ids) ascending."""
        q = to_device(queries, self.device, torch.float32)
        single = q.dim() == 1
        if single:
            q = q[None, :]
        if self.is_empty:
            b = q.shape[0]
            d = torch.zeros((b, 0), dtype=torch.float32, device=self.device)
            ids = torch.zeros((b, 0), dtype=torch.int32, device=self.device)
            return (d[0], ids[0]) if single else (d, ids)
        ef = max(ef, k)
        qp = dist_ops.prep_query(q, self.config.metric)
        cur = torch.full((qp.shape[0],), self.entry_point, dtype=torch.int32,
                         device=self.device)
        for layer in reversed(self.layers):  # top layer first
            # The entry point reaches every upper layer; clamp all the same.
            local = torch.clamp(layer.g2l_dev[cur.long()], min=0)
            local = _greedy_descend(qp, layer.neighbors, layer.x_local, local,
                                    self.config.metric)
            cur = layer.ids_dev[local.long()]
        if max_iters is None:
            max_iters = default_max_iters(ef, expand_width)
        dists, ids = batched_search(qp, self.x, self.layer0.neighbors, cur,
                                    scorer=make_stored_scorer(self.config.metric), ef=ef,
                                    expand_width=expand_width, max_iters=max_iters)
        dists, ids = dists[:, :k], ids[:, :k]
        return (dists[0], ids[0]) if single else (dists, ids)
