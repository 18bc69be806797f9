"""Batched best-first graph search.

Port of islands_tpu/core/search.py, batch-major: the reference vmaps a
single-query `lax.while_loop`; here every function takes the whole batch
[B, ...] and the hop loop is a Python loop (`_run_hops`).

The search keeps, per query, a fixed-width ascending pool of (distance,
packed id+expanded code); each hop expands the best `expand_width`
unexpanded entries, dedups their neighbours against the hop and the pool,
scores them and merges them in. Three loops:
- `batched_search`: the exact gate, every discovery scored exactly;
- `batched_sketch_search`: the build's loop, driven by sketch distances;
- `batched_sketch_gated_query`: the query loop; sketch distances feed an
  approximate queue (AQ) and only its best `promote_width` entries per hop
  are scored exactly. `hop_merge="fused"` runs the AQ update as kernel K1
  (ops/hop_merge.py); `"inline"` composes it from ops/merge.py.
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.config import DistanceMetric
from islands_tpu_torch.core.csr import SENTINEL, CsrGraph
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.ops.hop_merge import HOLE, hop_merge
from islands_tpu_torch.ops.merge import merge_sorted_with_new, pack_id_expanded, smallest_k

_INF = float("inf")


def stored_scorer(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    """Exact distances over stored (prepped) embeddings x [N, d]: q [B, d],
    ids/valid [B, E] -> [B, E], +inf where not valid."""
    rows = x[torch.clamp(ids, 0, x.shape[0] - 1).long()]
    d = dist_ops.rowwise_distance(q, rows, metric)
    return torch.where(valid, d, _INF)


def _run_hops(cond, body, state: tuple, max_iters: int, static_iters: bool):
    """The reference vmaps a `lax.while_loop`, so each query's state freezes
    once its own `cond` is false while the others keep hopping. Here `cond`
    gives a [B] mask, the body runs on the whole batch, and rows whose cond
    was false keep their old state (`torch.where(active, new, old)`); the
    loop stops when no query is active or after `max_iters` hops.

    `static_iters=True` is the reference's fixed-trip `lax.scan`: exactly
    `max_iters` hops with no freeze (the body is a fixed point on converged
    queries)."""
    if static_iters:
        for _ in range(max_iters):
            state = body(state)
        return state
    for _ in range(max_iters):
        active = cond(state)
        if not bool(active.any()):
            break
        new = body(state)
        state = tuple(
            torch.where(active.view(-1, *([1] * (o.dim() - 1))), nw, o)
            for nw, o in zip(new, state))
    return state


def _not_in_set(ids: torch.Tensor, member_ids: torch.Tensor) -> torch.Tensor:
    """[B, E] mask of ids NOT present in member_ids [B, P] (the reference's
    scatter-free visited test: pool eviction is monotone, so membership in
    the current pool is enough)."""
    return ~torch.any(ids[:, :, None] == member_ids[:, None, :], dim=2)


def _dedup_sorted(ids: torch.Tensor, num_nodes: int, d: torch.Tensor | None = None):
    """Sort ids [B, E] ascending, carrying `d` [B, E] along, and mask
    duplicates and invalid ids (set to `num_nodes` beforehand). The sort is
    stable, as the reference's lax.sort is, so duplicates keep their slot
    order. Returns (sorted_ids, keep, d in sorted order or None)."""
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    prev = torch.cat([sorted_ids.new_full((ids.shape[0], 1), -2),
                      sorted_ids[:, :-1]], dim=1)
    keep = (sorted_ids < num_nodes) & (sorted_ids != prev)
    return sorted_ids, keep, None if d is None else d.gather(1, order)


def _init_pool(entry: torch.Tensor, d_entry: torch.Tensor, ef: int):
    b = entry.shape[0]
    pool_code = entry.new_full((b, ef), -1)
    pool_code[:, 0] = pack_id_expanded(entry, torch.zeros_like(entry, dtype=torch.bool))
    pool_d = d_entry.new_full((b, ef), _INF)
    pool_d[:, 0] = d_entry
    return pool_d, pool_code


def _exact_cond(pool_d, pool_code):
    unexp = torch.where((pool_code & 1) == 1, _INF, pool_d)
    best_unexp = unexp.min(dim=1).values
    worst = pool_d[:, -1]
    return (best_unexp < _INF) & (best_unexp <= worst)


def _pop(pool_d, pool_code, expand_width: int):
    """Mark the best `expand_width` unexpanded entries expanded; the
    reference takes them with lax.top_k (lower position first on ties), as
    `smallest_k` does. Returns (pool_code, sel_ids [B, X], sel_valid [B, X])."""
    unexp = torch.where((pool_code & 1) == 1, _INF, pool_d)
    sel_pos = smallest_k(unexp, expand_width)
    sel_valid = unexp.gather(1, sel_pos) < _INF
    sel_code = pool_code.gather(1, sel_pos) | 1
    pool_code = pool_code.scatter(1, sel_pos, sel_code)
    return pool_code, sel_code >> 1, sel_valid


def _expand(neighbors, sel_ids, sel_valid):
    """Neighbour ids of the selected nodes -> (safe [B, X], ids [B, X*M],
    valid [B, X*M])."""
    n, m = neighbors.shape
    b, xw = sel_ids.shape
    safe = torch.clamp(sel_ids, 0, n - 1).long()
    nbr_ids = neighbors[safe].reshape(b, xw * m)
    nbr_valid = (sel_valid[:, :, None].expand(b, xw, m).reshape(b, xw * m)
                 & (nbr_ids != SENTINEL))
    return safe, nbr_ids, nbr_valid


def batched_search(qp, x_prepped, neighbors, entry_point, *, metric, ef,
                   expand_width=4, max_iters=100):
    """Exact-gate search. qp [B, d] prepped queries, entry_point int or [B]
    -> (dists [B, ef], ids [B, ef]) ascending."""
    b = qp.shape[0]
    n, _ = neighbors.shape
    entry = torch.as_tensor(entry_point, dtype=torch.int32, device=qp.device)
    entry = torch.clamp(entry.expand(b), min=0).contiguous()
    d_entry = stored_scorer(x_prepped, qp, entry[:, None],
                            torch.ones((b, 1), dtype=torch.bool, device=qp.device),
                            metric)[:, 0]
    pool_d, pool_code = _init_pool(entry, d_entry, ef)

    def body(state):
        pool_d, pool_code = state
        pool_code, sel_ids, sel_valid = _pop(pool_d, pool_code, expand_width)
        _, nbr_ids, nbr_valid = _expand(neighbors, sel_ids, sel_valid)
        nbr_ids = torch.where(nbr_valid, nbr_ids, n)
        sorted_ids, keep, _ = _dedup_sorted(nbr_ids, n)
        keep = keep & _not_in_set(sorted_ids, pool_code >> 1)
        new_d = stored_scorer(x_prepped, qp, sorted_ids, keep, metric)
        new_code = pack_id_expanded(torch.where(keep, sorted_ids, SENTINEL), ~keep)
        all_d, all_code = merge_sorted_with_new(pool_d, pool_code, new_d, new_code)
        return all_d[:, :ef], all_code[:, :ef]

    pool_d, pool_code = _run_hops(lambda st: _exact_cond(*st), body, (pool_d, pool_code),
                                  max_iters, False)
    return pool_d, pool_code >> 1


def _sketch_hop(neighbors, nbr_sketch, sel_ids, sel_valid):
    """Ids [B, E], validity [B, E] and unpacked sketches [B, E, P] of the
    selected nodes' neighbours, read from the inline sketch blocks."""
    safe, nbr_ids, nbr_valid = _expand(neighbors, sel_ids, sel_valid)
    b, em = nbr_ids.shape
    raw = proj_ops.unpack_raw(nbr_sketch[safe].reshape(b, em, -1))
    return nbr_ids, nbr_valid, raw


def batched_sketch_search(qs, neighbors, nbr_sketch, node_sketch, entry_point,
                          *, metric, ef, expand_width=4, max_iters=100):
    """Build-time search driven by sketch distances only. qs [B, P] scaled
    query sketches, entry_point int or [B] -> (approx dists [B, ef],
    ids [B, ef])."""
    b = qs.shape[0]
    n, _ = neighbors.shape
    entry = torch.as_tensor(entry_point, dtype=torch.int32, device=qs.device)
    entry = torch.clamp(entry.expand(b), min=0).contiguous()
    entry_raw = proj_ops.unpack_raw(node_sketch[entry.long()])
    d_entry = proj_ops.sketch_distance(qs, entry_raw, metric)
    pool_d, pool_code = _init_pool(entry, d_entry, ef)

    def body(state):
        pool_d, pool_code = state
        pool_code, sel_ids, sel_valid = _pop(pool_d, pool_code, expand_width)
        nbr_ids, nbr_valid, raw = _sketch_hop(neighbors, nbr_sketch, sel_ids, sel_valid)
        d = proj_ops.sketch_distance(qs, raw, metric)
        d = torch.where(nbr_valid, d, _INF)
        nbr_ids = torch.where(nbr_valid, nbr_ids, n)
        # Dedup by id carrying the (identical-per-id) sketch distances.
        sorted_ids, keep, d = _dedup_sorted(nbr_ids, n, d)
        keep = keep & _not_in_set(sorted_ids, pool_code >> 1)
        new_d = torch.where(keep, d, _INF)
        new_code = pack_id_expanded(torch.where(keep, sorted_ids, SENTINEL), ~keep)
        all_d, all_code = merge_sorted_with_new(pool_d, pool_code, new_d, new_code)
        return all_d[:, :ef], all_code[:, :ef]

    pool_d, pool_code = _run_hops(lambda st: _exact_cond(*st), body, (pool_d, pool_code),
                                  max_iters, False)
    return pool_d, pool_code >> 1


def batched_sketch_gated_query(qp, qs, x_prepped, scale, neighbors, nbr_sketch,
                               node_sketch, routing_ids, *, metric, dim, ef, k,
                               aq_width, promote_width, expand_width=4,
                               max_iters=100, static_iters=False,
                               final_rescore=0, hop_merge_mode="inline"):
    """Two-level sketch-gated query with per-query routing entries.

    The pool (and so navigation and termination) runs on EXACT distances;
    calibrated sketch distances of each hop's discoveries feed the AQ, and
    its best `promote_width` entries per hop are scored exactly.
    Returns (dists [B, k], ids [B, k], n_exact [B])."""
    b = qp.shape[0]
    n, m = neighbors.shape
    em = expand_width * m
    if hop_merge_mode not in ("inline", "fused"):
        raise ValueError(f"hop_merge must be 'inline' or 'fused', got {hop_merge_mode!r}")
    if hop_merge_mode == "fused" and n >= HOLE:
        raise ValueError(f"the fused hop-merge needs n < 2^30, got {n}")
    # A hop discovers at most em candidates; a wider promote window would
    # shrink the AQ slice below aq_width.
    promote_width = min(promote_width, em)

    entry = route_entries(qs, routing_ids, node_sketch, metric)
    ones = torch.ones((b, 1), dtype=torch.bool, device=qp.device)
    d_entry = stored_scorer(x_prepped, qp, entry[:, None], ones, metric)[:, 0]
    pool_d, pool_code = _init_pool(entry, d_entry, ef)
    aq_i = torch.full((b, aq_width), SENTINEL, dtype=torch.int32, device=qp.device)
    aq_d = torch.full((b, aq_width), _INF, dtype=torch.float32, device=qp.device)
    n_exact = torch.ones((b,), dtype=torch.int32, device=qp.device)

    def cond(state):
        pool_d, pool_code, aq_d, _, _ = state
        exact_work = _exact_cond(pool_d, pool_code)
        worst = pool_d[:, -1]
        # Keep hopping while the AQ head is within half the pool's spread
        # of the worst pooled distance (sketch noise margin).
        margin = 0.5 * (worst - pool_d[:, 0])
        aq_work = (aq_d[:, 0] < _INF) & (aq_d[:, 0] <= worst + margin)
        return exact_work | aq_work

    def body(state):
        pool_d, pool_code, aq_d, aq_i, n_exact = state
        pool_code, sel_ids, sel_valid = _pop(pool_d, pool_code, expand_width)
        nbr_ids, nbr_valid, raw = _sketch_hop(neighbors, nbr_sketch, sel_ids, sel_valid)
        d_approx = proj_ops.sketch_distance_calibrated(qs, raw, metric, scale, dim)
        d_approx = torch.where(nbr_valid, d_approx, _INF)
        nbr_ids = torch.where(nbr_valid, nbr_ids, n)

        if hop_merge_mode == "fused":
            # Membership against AQ and pool stays out here (order-free);
            # the id-sort dedup, descending sort, AQ merge and promote split
            # run in K1.
            keep = ((nbr_ids < n) & _not_in_set(nbr_ids, aq_i)
                    & _not_in_set(nbr_ids, pool_code >> 1))
            nd = torch.where(keep, d_approx, _INF)
            ni = torch.where(keep, nbr_ids, n).to(torch.int32)
            prom_d, prom_ids, aq_d, aq_i = hop_merge(nd, ni, aq_d, aq_i, promote_width)
            prom_valid = prom_d < _INF
        else:
            sorted_ids, keep, d_approx = _dedup_sorted(nbr_ids, n, d_approx)
            keep = keep & _not_in_set(sorted_ids, aq_i)
            keep = keep & _not_in_set(sorted_ids, pool_code >> 1)
            new_ids = torch.where(keep, sorted_ids, SENTINEL)
            new_d = torch.where(keep, d_approx, _INF)
            aq_d_all, aq_i_all = merge_sorted_with_new(aq_d, aq_i, new_d, new_ids)
            prom_ids = aq_i_all[:, :promote_width]
            prom_valid = aq_d_all[:, :promote_width] < _INF
            aq_d = aq_d_all[:, promote_width:promote_width + aq_width]
            aq_i = aq_i_all[:, promote_width:promote_width + aq_width]

        d_exact = stored_scorer(x_prepped, qp, torch.where(prom_valid, prom_ids, 0),
                                prom_valid, metric)
        n_exact = n_exact + prom_valid.sum(dim=1, dtype=torch.int32)
        prom_code = pack_id_expanded(torch.where(prom_valid, prom_ids, SENTINEL),
                                     ~prom_valid)
        all_d, all_code = merge_sorted_with_new(pool_d, pool_code, d_exact, prom_code)
        return all_d[:, :ef], all_code[:, :ef], aq_d, aq_i, n_exact

    state = (pool_d, pool_code, aq_d, aq_i, n_exact)
    pool_d, pool_code, aq_d, aq_i, n_exact = _run_hops(
        cond, body, state, max_iters, static_iters)
    if final_rescore > 0:
        # One end-of-loop exact rescore of the AQ head merges true
        # neighbours a narrow promote_width left in the queue.
        fr = min(final_rescore, aq_width)
        fr_ids = aq_i[:, :fr]
        fr_valid = aq_d[:, :fr] < _INF
        d_fr = stored_scorer(x_prepped, qp, torch.where(fr_valid, fr_ids, 0),
                             fr_valid, metric)
        n_exact = n_exact + fr_valid.sum(dim=1, dtype=torch.int32)
        fr_code = pack_id_expanded(torch.where(fr_valid, fr_ids, SENTINEL), ~fr_valid)
        all_d, all_code = merge_sorted_with_new(pool_d, pool_code, d_fr, fr_code)
        pool_d, pool_code = all_d[:, :ef], all_code[:, :ef]
    return pool_d[:, :k], (pool_code >> 1)[:, :k], n_exact


def route_entries(qs: torch.Tensor, routing_ids: torch.Tensor,
                  node_sketch: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    """Per-query entry points [B]: the routing node whose sketch is nearest
    (one [B, R] matmul). argmin returns the first minimum, as the
    reference's does."""
    raw = proj_ops.unpack_raw(node_sketch[routing_ids.long()])  # [R, P]
    if proj_ops.uses_dot(metric):
        d = -(qs @ raw.T)
    else:
        d = (torch.sum(qs * qs, dim=1)[:, None] + torch.sum(raw * raw, dim=1)[None, :]
             - 2.0 * (qs @ raw.T))
    return routing_ids[torch.argmin(d, dim=1)].to(torch.int32)


def default_max_iters(ef: int, expand_width: int) -> int:
    return 4 * max(ef // max(expand_width, 1), 1) + 16


class StoredSearcher:
    """Search handle over a graph + stored embeddings.

    With a `sketch` (ops/proj.SketchIndex), queries default to the
    sketch-gated path: per-query routing entries, hops over inline neighbour
    sketch blocks, exact scoring of the AQ heads. gate="exact" runs the
    per-hop exact loop. Runs on CUDA unless `device="cpu"` is asked for; the
    graph, corpus and sketch move to that device."""

    def __init__(self, graph: CsrGraph, x, metric: DistanceMetric = DistanceMetric.COSINE,
                 sketch: proj_ops.SketchIndex | None = None, routing_size: int = 1024,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.graph = CsrGraph(graph.neighbors.to(dev), graph.degrees.to(dev),
                              graph.levels.to(dev), graph.entry_point, graph.max_level)
        self.metric = metric
        self.x_prepped = dist_ops.prep_corpus(to_device(x, dev), metric)
        if sketch is not None:
            sketch = proj_ops.SketchIndex(
                w=sketch.w.to(dev, torch.float32), scale=sketch.scale.to(dev),
                node_sketch=sketch.node_sketch.to(dev),
                nbr_sketch=sketch.nbr_sketch.to(dev))
        self.sketch = sketch
        n = graph.num_nodes
        if sketch is not None and n > 0:
            # numpy draw, so the routing nodes equal the reference's.
            rng = np.random.default_rng(seed)
            self._routing = torch.as_tensor(
                rng.integers(0, n, size=min(routing_size, n)), dtype=torch.int32,
                device=dev)
        else:
            self._routing = None

    def search(self, queries, k: int, ef: int = 64, expand_width: int = 4,
               max_iters: int | None = None, gate: str = "auto",
               promote_width: int | None = None, static_loop: bool = False,
               final_rescore: int = 0, aq_width: int | None = None,
               hop_merge: str = "inline") -> tuple[torch.Tensor, torch.Tensor]:
        """queries [B, d] -> (dists [B, k], ids [B, k]) ascending; the knobs
        are the reference's StoredSearcher.search's."""
        queries = to_device(queries, self.device)
        b = queries.shape[0]
        if self.graph.num_nodes == 0:
            return (torch.zeros((b, 0), dtype=torch.float32, device=self.device),
                    torch.zeros((b, 0), dtype=torch.int32, device=self.device))
        ef = max(ef, k)
        qp = dist_ops.prep_query(queries, self.metric)
        if gate == "auto":
            gate = "sketch" if self.sketch is not None else "exact"
        if gate == "sketch":
            if self.sketch is None:
                raise ValueError("no SketchIndex attached (gate='sketch')")
            qs = proj_ops.sketch_query(qp, self.sketch.w, self.sketch.scale)
            promote = promote_width or max(8, min(2 * expand_width * 4, ef))
            if max_iters is None:
                max_iters = 8 * max(ef // promote, 1) + 32
            d, ids, _ = batched_sketch_gated_query(
                qp, qs, self.x_prepped, self.sketch.scale, self.graph.neighbors,
                self.sketch.nbr_sketch, self.sketch.node_sketch, self._routing,
                metric=self.metric, dim=int(qp.shape[1]), ef=ef, k=k,
                aq_width=aq_width or max(ef, 64), promote_width=promote,
                expand_width=expand_width, max_iters=max_iters,
                static_iters=static_loop, final_rescore=final_rescore,
                hop_merge_mode=hop_merge)
            return d, ids
        if gate != "exact":
            raise ValueError(f"unknown gate {gate!r}")
        if max_iters is None:
            max_iters = default_max_iters(ef, expand_width)
        entry = self.graph.entry_point
        if self.sketch is not None:
            # Routing entries help the exact gate too.
            qs = proj_ops.sketch_query(qp, self.sketch.w, self.sketch.scale)
            entry = route_entries(qs, self._routing, self.sketch.node_sketch, self.metric)
        dists, ids = batched_search(qp, self.x_prepped, self.graph.neighbors, entry,
                                    metric=self.metric, ef=ef,
                                    expand_width=expand_width, max_iters=max_iters)
        return dists[:, :k], ids[:, :k]
