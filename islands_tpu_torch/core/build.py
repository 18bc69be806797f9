"""Wave-batched graph construction.

Port of islands_tpu/core/build.py (insertion waves). Vectors are inserted
in waves; each wave
  1. searches the pre-wave graph for candidates (sketch-gated: hops over
     inline neighbour sketches, then one exact rescore of the pool),
  2. adds brute-force intra-wave nearest neighbours,
  3. selects m0 neighbours (reserved hubs by degree, then RNG-diverse
     candidates, then the rest, nearest first),
  4. writes forward edges and appends reverse edges into per-node slack,
  5. repairs rows that went over m0.

The reference's jitted wave step donates the graph state; here `neighbors`,
`degrees` and `nbr_sketch` are updated IN PLACE for the same reason (at 1M
nodes `nbr_sketch` is ~4 GB). Its `mode="drop"` scatters become masked
index writes: out-of-range targets are filtered out before `index_put_`.
Torch indexes with int64, so the reference's int32-overflow fallback for
large flat scatters is not needed.

With `config.refine_passes > 0` the build runs refine passes after the
insertion waves: every node re-searches the complete graph and re-selects
its row (`wave_body(refine=True)`).

`extend_graph` appends nodes to a built graph with the same waves, on the
exact path (no sketch), the incremental re-index of LeannIndex.extend and
HnswIndex.extend.
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.csr import SENTINEL, CsrGraph
from islands_tpu_torch.core.search import (
    batched_search,
    batched_sketch_search,
    make_stored_scorer,
    route_entries,
)
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.ops.merge import argsort, smallest_k

_INF = float("inf")
_IMAX = 2**31 - 1


def sample_levels(n: int, ml: float, max_layers: int, seed: int) -> np.ndarray:
    """Geometric level assignment floor(-ln(U) * ml), capped (numpy, so it
    equals the reference's draw)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    levels = np.floor(-np.log(np.maximum(u, 1e-12)) * ml).astype(np.int32)
    return np.minimum(levels, max_layers - 1)


def _prefix_entries(levels: np.ndarray) -> np.ndarray:
    """entry[i] = entry point of the graph holding nodes [0, i): the first
    node reaching the running max level."""
    n = len(levels)
    entries = np.zeros(n + 1, dtype=np.int32)
    best, best_id = -1, 0
    for i in range(n):
        entries[i] = best_id
        if levels[i] > best:
            best, best_id = int(levels[i]), i
    entries[n] = best_id
    entries[0] = 0
    return entries


def _rank_of(keys: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of element i in a stable ascending sort."""
    return torch.argsort(argsort(keys), dim=-1, stable=True)


def _diversity_mask(cand_dists, cand_emb, valid, metric: DistanceMetric):
    """[W, C] strict-RNG mask: reject candidate i iff some valid j strictly
    closer to the query also sits closer to i than the query does."""
    d_cc = dist_ops.pairwise_distance(cand_emb, cand_emb, metric)  # [W, C, C]
    closer = (cand_dists[:, None, :] < cand_dists[:, :, None]) & valid[:, None, :]
    dominated = torch.any(closer & (d_cc < cand_dists[:, :, None]), dim=2)
    return valid & ~dominated


def _select_neighbors(cand_ids, cand_dists, cand_emb, degrees, *, m0: int,
                      hub_percentile: float, high_degree_pruning: bool,
                      diversify: bool, metric: DistanceMetric):
    """Per-row selection of m0 neighbours from [W, C] candidates: reserved
    hubs (degree desc), then diversity-passing regulars, then the remaining
    regulars (distance asc), then leftover hubs. -> (ids, dists) [W, m0]."""
    w, c = cand_ids.shape
    n = degrees.shape[0]
    valid = (cand_ids >= 0) & (cand_dists < _INF)
    hub_slots = max(m0 // 4, 1)

    deg = torch.where(valid, degrees[torch.clamp(cand_ids, 0, n - 1).long()], -1)
    if high_degree_pruning:
        n_valid = valid.sum(dim=1, dtype=torch.int32)
        hub_count = torch.ceil(n_valid.float() * hub_percentile).to(torch.int32)
        sorted_deg = torch.sort(deg, dim=1, descending=True).values
        thr_idx = torch.clamp(hub_count - 1, 0, c - 1).long()
        threshold = torch.where((hub_count > 0) & (hub_count < n_valid),
                                sorted_deg.gather(1, thr_idx[:, None])[:, 0], _IMAX)
        is_hub = valid & (deg >= threshold[:, None]) & (threshold[:, None] < _IMAX)
    else:
        is_hub = torch.zeros_like(valid)

    diverse = _diversity_mask(cand_dists, cand_emb, valid, metric) if diversify else valid

    hub_rank = _rank_of(torch.where(is_hub, -deg, _IMAX))
    div_rank = _rank_of(torch.where(valid & ~is_hub & diverse, cand_dists, _INF))
    rest_rank = _rank_of(torch.where(valid & ~is_hub & ~diverse, cand_dists, _INF))

    big = 8 * c
    priority = torch.where(
        is_hub & (hub_rank < hub_slots), hub_rank,
        torch.where(valid & ~is_hub & diverse, hub_slots + div_rank,
                    torch.where(valid & ~is_hub, hub_slots + c + rest_rank,
                                torch.where(is_hub, hub_slots + 2 * c + hub_rank,
                                            torch.full_like(hub_rank, big)))))
    # Candidate width can be below m0: clamp the selection, pad to m0.
    kk = min(m0, c)
    sel_pos = smallest_k(priority, kk)  # lax.top_k(-priority, kk)
    sel_ok = priority.gather(1, sel_pos) < big
    sel_ids = torch.where(sel_ok, cand_ids.gather(1, sel_pos), SENTINEL)
    sel_dists = torch.where(sel_ok, cand_dists.gather(1, sel_pos), _INF)
    if kk < m0:
        sel_ids = torch.nn.functional.pad(sel_ids, (0, m0 - kk), value=SENTINEL)
        sel_dists = torch.nn.functional.pad(sel_dists, (0, m0 - kk), value=_INF)
    return sel_ids, sel_dists


def _repair_rows(neighbors, degrees, node_ids, x_prepped, m0: int,
                 metric: DistanceMetric, diversify: bool = False,
                 nbr_sketch=None, w=None, scale=None) -> None:
    """Re-prune the rows of `node_ids` IN PLACE: dedup, score against the
    node's own embedding, keep the m0 nearest (diversity-passing first when
    `diversify`) and rewrite the rows' inline sketches.

    Ids outside [0, n) are no-ops (the reference's mode="drop"); they are
    filtered out first, since every row's repair reads and writes only that
    row."""
    n, bw = neighbors.shape
    node_ids = node_ids[(node_ids >= 0) & (node_ids < n)].long()
    if node_ids.numel() == 0:
        return
    rows = neighbors[node_ids]  # [R, BW]
    r = rows.shape[0]

    sorted_rows = torch.sort(torch.where(rows == SENTINEL, n, rows), dim=1).values
    prev = torch.cat([sorted_rows.new_full((r, 1), -2), sorted_rows[:, :-1]], dim=1)
    keep = (sorted_rows < n) & (sorted_rows != prev)

    q = x_prepped[node_ids]
    nbr_emb = x_prepped[torch.clamp(sorted_rows, 0, x_prepped.shape[0] - 1).long()]
    d = dist_ops.rows_distance(q, nbr_emb, metric)
    d = torch.where(keep, d, _INF)

    order = argsort(d)
    d_sorted = d.gather(1, order)
    ids_sorted = sorted_rows.gather(1, order)
    emb_sorted = nbr_emb.gather(1, order[:, :, None].expand_as(nbr_emb))
    kth_valid = d_sorted < _INF

    cols = torch.arange(bw, device=neighbors.device)[None, :]
    if diversify:
        diverse = _diversity_mask(d_sorted, emb_sorted, kth_valid, metric)
        # Diversity-passing first (already distance-ordered), rest after.
        prio = torch.where(diverse & kth_valid, cols,
                           torch.where(kth_valid, bw + cols, 4 * bw))
        reorder = argsort(prio)
        d_sorted = d_sorted.gather(1, reorder)
        ids_sorted = ids_sorted.gather(1, reorder)
        emb_sorted = emb_sorted.gather(1, reorder[:, :, None].expand_as(emb_sorted))
        kth_valid = d_sorted < _INF

    slot_live = kth_valid & (cols < m0)
    neighbors[node_ids] = torch.where(slot_live, ids_sorted, SENTINEL).to(torch.int32)
    degrees[node_ids] = slot_live.sum(dim=1, dtype=torch.int32)

    if nbr_sketch is not None:
        sk = proj_ops.quantize_pack(emb_sorted @ w, scale)  # [R, BW, P/4]
        sk = torch.where(slot_live[:, :, None], sk, 0)
        nbr_sketch[node_ids] = sk.reshape(r, -1)


def _scatter_reverse_edges(neighbors, degrees, sel_ids, sel_dists, src_ids,
                           edge_valid, nbr_sketch=None, node_sketch=None) -> None:
    """Append src -> slot in each selected neighbour's row, IN PLACE.

    Edges are sorted by (dst, dist), so when a row's slack fills up within a
    wave the nearest sources win the slots. The reference sorts 3 operands
    with num_keys=2; here that is two stable sorts, by dist and then by dst.
    With `nbr_sketch`, each inserted edge also writes the source's packed
    sketch into the destination row's slot."""
    n, bw = neighbors.shape
    dst = torch.where(edge_valid, sel_ids, n).reshape(-1)
    dist = torch.where(edge_valid, sel_dists, _INF).reshape(-1)
    src = src_ids.reshape(-1)

    by_dist = argsort(dist)
    by_dst = torch.argsort(dst[by_dist], stable=True)
    perm = by_dist[by_dst]
    dst_s, src_s = dst[perm], src[perm]
    e = dst_s.shape[0]
    idx = torch.arange(e, device=dst_s.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dst_s.device),
                          dst_s[1:] != dst_s[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = idx - seg_start

    slot = degrees[torch.clamp(dst_s, 0, n - 1).long()] + pos
    ok = (dst_s < n) & (slot < bw)
    # mode="drop": only in-range (dst, slot) pairs are written; they are
    # unique, since pos counts up within each dst's run.
    dst_w = dst_s[ok].long()
    flat = dst_w * bw + slot[ok]
    src_w = src_s[ok]
    neighbors.view(-1)[flat] = src_w.to(torch.int32)
    degrees.index_add_(0, dst_w, torch.ones_like(dst_w, dtype=torch.int32))
    if nbr_sketch is not None:
        p4 = node_sketch.shape[-1]
        src_sk = node_sketch[torch.clamp(src_w, 0, node_sketch.shape[0] - 1).long()]
        nbr_sketch.view(n * bw, p4)[flat] = src_sk


def wave_body(neighbors, degrees, nbr_sketch, s: int, entry: int, x_prepped,
              count: int, sketch_ctx=None, *, config: LeannConfig, wave: int,
              buffer_width: int, max_iters: int, refine: bool = False) -> None:
    """One insertion wave: insert nodes [s, s+wave) IN PLACE. `x_prepped`
    is padded to at least s + wave rows; rows >= `count` never insert.
    `sketch_ctx` = (node_sketch, node_proj_q, routing_ids, w, scale).

    `refine=True` re-selects the rows of already-inserted nodes instead: the
    pool is self-masked, each node's current row joins the candidates with
    exact distances, candidates are deduped by id, there is no intra-wave
    brute force, and reverse edges whose destination row already holds the
    source are dropped (rows at degree <= m0 are never repaired, so they
    would keep the duplicate)."""
    n = neighbors.shape[0]
    dev = neighbors.device
    m0 = config.m0
    efc = config.ef_construction
    metric = config.metric
    intra_k = min(config.intra_wave_k, wave - 1) if wave > 1 else 0

    wave_ids = s + torch.arange(wave, dtype=torch.int32, device=dev)
    wave_ok = wave_ids < count
    q = x_prepped[s:s + wave]

    # 1. candidates from the existing graph
    if nbr_sketch is not None:
        node_sketch, node_proj_q, routing_ids, w, scale = sketch_ctx
        qs = node_proj_q[s:s + wave]
        entries_q = route_entries(qs, routing_ids, node_sketch, metric)
        # Over-provisioned approximate pool, exact-rescored; the best efc by
        # true distance survive.
        ef_pool = efc * max(config.sketch_pool_mult, 1)
        _, pool_ids = batched_sketch_search(
            qs, neighbors, nbr_sketch, node_sketch, entries_q, metric=metric,
            ef=ef_pool, expand_width=config.expand_width, max_iters=max_iters)
        rows = x_prepped[torch.clamp(pool_ids, 0, x_prepped.shape[0] - 1).long()]
        pool_d = dist_ops.rows_distance(q, rows, metric)
        pool_d = torch.where(pool_ids >= 0, pool_d, _INF)
        if ef_pool > efc:
            pos = smallest_k(pool_d, efc)  # lax.top_k(-pool_d, efc)
            g_dists = pool_d.gather(1, pos)
            g_ids = torch.where(g_dists < _INF, pool_ids.gather(1, pos), SENTINEL)
        else:
            g_dists, g_ids = pool_d, pool_ids
    else:
        g_dists, g_ids = batched_search(
            q, x_prepped, neighbors, entry, scorer=make_stored_scorer(metric), ef=efc,
            expand_width=config.expand_width, max_iters=max_iters)

    if refine:
        self_hit = g_ids == wave_ids[:, None]
        g_ids = torch.where(self_hit, SENTINEL, g_ids)
        g_dists = torch.where(self_hit, _INF, g_dists)
        cur_rows = neighbors[torch.clamp(wave_ids, 0, n - 1).long()]  # [W, BW]
        cur_ok = (cur_rows != SENTINEL) & wave_ok[:, None]
        cur_emb = x_prepped[torch.clamp(cur_rows, 0, x_prepped.shape[0] - 1).long()]
        cur_d = torch.where(cur_ok, dist_ops.rows_distance(q, cur_emb, metric), _INF)
        cand_ids = torch.cat([g_ids, torch.where(cur_ok, cur_rows, SENTINEL)], dim=1)
        cand_dists = torch.cat([g_dists, cur_d], dim=1)
        # Dedup by id: a stable sort on the id alone (lax.sort, num_keys=1),
        # so the pool's copy of a duplicate comes first and wins.
        key = torch.where(cand_ids == SENTINEL, n, cand_ids)
        order = argsort(key)
        key_s = key.gather(1, order)
        prev = torch.cat([key_s.new_full((wave, 1), -2), key_s[:, :-1]], dim=1)
        drop = (key_s == prev) | (key_s >= n)
        cand_ids = torch.where(drop, SENTINEL, cand_ids.gather(1, order))
        cand_dists = torch.where(drop, _INF, cand_dists.gather(1, order))
    # 2. intra-wave brute-force candidates (insertion waves only)
    elif intra_k > 0:
        dq = dist_ops.pairwise_distance(q, q, metric)
        eye = torch.eye(wave, dtype=torch.bool, device=dev)
        dq = torch.where(~wave_ok[None, :] | eye, _INF, dq)
        pos = smallest_k(dq, intra_k)  # lax.top_k(-dq, intra_k)
        intra_dists = dq.gather(1, pos)
        intra_ids = torch.where(intra_dists < _INF, s + pos.to(torch.int32), SENTINEL)
        cand_ids = torch.cat([g_ids, intra_ids], dim=1)
        cand_dists = torch.cat([g_dists, intra_dists], dim=1)
    else:
        cand_ids, cand_dists = g_ids, g_dists

    # 3. hub-preserving + diversity selection to m0
    cand_emb = x_prepped[torch.clamp(cand_ids, 0, x_prepped.shape[0] - 1).long()]
    sel_ids, sel_dists = _select_neighbors(
        cand_ids, cand_dists, cand_emb, degrees, m0=m0,
        hub_percentile=config.hub_percentile,
        high_degree_pruning=config.high_degree_pruning,
        diversify=config.diversify, metric=metric)
    sel_ids = torch.where(wave_ok[:, None], sel_ids, SENTINEL)
    sel_dists = torch.where(wave_ok[:, None], sel_dists, _INF)

    # 4a. forward edges (rows >= count are dropped)
    live = wave_ids[wave_ok].long()
    nl = live.shape[0]
    fwd = torch.full((nl, buffer_width), SENTINEL, dtype=torch.int32, device=dev)
    fwd[:, :m0] = sel_ids[:nl]
    neighbors[live] = fwd
    degrees[live] = (sel_ids[:nl] != SENTINEL).sum(dim=1, dtype=torch.int32)
    if nbr_sketch is not None:
        p4 = node_sketch.shape[-1]
        fwd_sk = node_sketch[torch.clamp(sel_ids[:nl], 0, node_sketch.shape[0] - 1).long()]
        fwd_sk = torch.where((sel_ids[:nl] != SENTINEL)[:, :, None], fwd_sk, 0)
        fwd_full = torch.zeros((nl, buffer_width, p4), dtype=torch.int32, device=dev)
        fwd_full[:, :m0] = fwd_sk
        nbr_sketch[live] = fwd_full.reshape(nl, -1)

    # 4b. reverse edges
    src = wave_ids[:, None].expand(wave, m0)
    edge_valid = (sel_ids != SENTINEL) & wave_ok[:, None]
    if refine:
        dest_rows = neighbors[torch.clamp(sel_ids, 0, n - 1).long()]  # [W, m0, BW]
        edge_valid = edge_valid & ~torch.any(dest_rows == src[:, :, None], dim=-1)
    _scatter_reverse_edges(neighbors, degrees, sel_ids, sel_dists, src, edge_valid,
                           nbr_sketch, node_sketch if nbr_sketch is not None else None)

    # 5. repair the wave's rows, then up to `wave` earlier rows now over m0
    # (jnp.where(size=wave) -> nonzero, first `wave`); rows past the cap are
    # picked up next wave or by the final sweep.
    sk_kw = (dict(nbr_sketch=nbr_sketch, w=w, scale=scale) if nbr_sketch is not None
             else {})
    _repair_rows(neighbors, degrees, live, x_prepped, m0, metric, config.diversify, **sk_kw)
    over = torch.nonzero(degrees > m0)[:wave, 0]
    _repair_rows(neighbors, degrees, over, x_prepped, m0, metric, config.diversify, **sk_kw)


def _bucket_size(n: int) -> int:
    """Structural padding: next power of two >= n (floor 512), with quarter
    steps above 2^20 (the reference's bucket, kept so the padded shapes and
    the waves' widths match it)."""
    b = 512
    while b < n:
        b *= 2
    if b > (1 << 20):
        for q in (4, 5, 6, 7):
            step = (b // 8) * q
            if n <= step:
                return step
    return b


def _final_sweep(neighbors, degrees, nbr_sketch, x_prepped, m0, metric,
                 diversify=False, w=None, scale=None, chunk=4096) -> None:
    """Repair every row still over m0, IN PLACE, in chunks of `chunk` rows
    (rows are independent, so only the rows that need it are visited)."""
    need = torch.nonzero(degrees > m0)[:, 0]
    sk_kw = dict(nbr_sketch=nbr_sketch, w=w, scale=scale) if nbr_sketch is not None else {}
    for start in range(0, need.shape[0], chunk):
        _repair_rows(neighbors, degrees, need[start:start + chunk], x_prepped, m0,
                     metric, diversify, **sk_kw)


def build_index(x, config: LeannConfig | None = None, levels=None,
                device=None) -> CsrGraph:
    """Build a proximity graph from embeddings [N, d]; max_degree == m0."""
    graph, _ = build_index_with_sketch(x, config, levels, want_sketch=False,
                                       device=device)
    return graph


def build_index_with_sketch(x, config: LeannConfig | None = None, levels=None,
                            want_sketch: bool = True, w=None, device=None):
    """Build the graph and (optionally) the SketchIndex kept during
    construction, cropped row-aligned with the final graph.

    `w` [dim, P] replaces the projection drawn from `config.seed` (tests
    pass the reference's matrix). Runs on CUDA unless `device="cpu"`."""
    config = config or LeannConfig()
    config.validate()
    dev = resolve_device(device)
    x = to_device(x, dev, torch.float32)
    n = int(x.shape[0])
    if n == 0:
        return CsrGraph.empty(0, config.m0, dev), None

    if levels is None:
        levels = sample_levels(n, config.ml, config.max_layers, config.seed)
    levels = np.asarray(levels, dtype=np.int32)
    entries = _prefix_entries(levels)

    x_prepped = dist_ops.prep_corpus(x, config.metric)
    m0 = config.m0
    buffer_width = m0 + config.reverse_slack
    n_pad = _bucket_size(n)
    max_wave = min(config.wave_size, n_pad)
    dim = x_prepped.shape[1]
    use_sketch = config.sketch_build and n > max(4 * m0, 256) and dim >= proj_ops.PACK
    pdims = min(config.sketch_dims, dim)
    pdims = max(pdims - pdims % proj_ops.PACK, proj_ops.PACK)
    if w is not None:
        w = to_device(w, dev, torch.float32)
        if tuple(w.shape) != (dim, pdims):
            raise ValueError(f"w must be [{dim}, {pdims}], got {tuple(w.shape)}")

    neighbors = torch.full((n_pad, buffer_width), SENTINEL, dtype=torch.int32, device=dev)
    degrees = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
    # Pad by one wave so the last wave's slice never runs short.
    x_padded = torch.nn.functional.pad(x_prepped, (0, 0, 0, n_pad + max_wave - n))
    if use_sketch:
        if w is None:
            w = proj_ops.make_projection(dim, pdims, config.seed, dev)
        node_proj = x_padded @ w
        scale = proj_ops.fit_scale(node_proj[:n])
        node_sketch = proj_ops.quantize_pack(node_proj, scale)
        node_proj_q = node_proj * scale
        del node_proj
        nbr_sketch = torch.zeros((n_pad, buffer_width * (pdims // proj_ops.PACK)),
                                 dtype=torch.int32, device=dev)
    else:
        scale = node_sketch = node_proj_q = nbr_sketch = None

    # wave 0: brute-force kNN over a seed set of up to one full wave.
    w0 = min(n, max(2 * m0, min(config.wave_size, 4096)))
    k0 = min(m0, w0 - 1)
    if k0 > 0:
        d0 = dist_ops.pairwise_distance(x_prepped[:w0], x_prepped[:w0], config.metric)
        d0 = torch.where(torch.eye(w0, dtype=torch.bool, device=dev), _INF, d0)
        nbr0 = smallest_k(d0, k0).to(torch.int32)  # lax.top_k(-d0, k0)
        neighbors[:w0, :k0] = nbr0
        degrees[:w0] = k0
        if use_sketch:
            p4 = pdims // proj_ops.PACK
            nbr_sketch[:w0, : k0 * p4] = node_sketch[nbr0.long()].reshape(w0, -1)

    # Later waves: width = the largest power of two <= the inserted prefix,
    # capped at wave_size (the reference's schedule); routing entries are a
    # numpy draw, so they equal the reference's.
    if w0 < n:
        max_iters = 4 * max(config.ef_construction // config.expand_width, 1) + 16
        rng = np.random.default_rng(config.seed ^ 0x5EED)
        s = w0
        while s < n:
            wave = min(max_wave, 1 << max(8, s.bit_length() - 1))
            sketch_ctx = None
            if use_sketch:
                routing = torch.as_tensor(rng.integers(0, s, size=config.routing_size),
                                          dtype=torch.int32, device=dev)
                sketch_ctx = (node_sketch, node_proj_q, routing, w, scale)
            wave_body(neighbors, degrees, nbr_sketch, s, int(entries[s]), x_padded, n,
                      sketch_ctx, config=config, wave=wave, buffer_width=buffer_width,
                      max_iters=max_iters)
            s += wave

    # Refine passes: every node re-searches the complete graph from the
    # final entry point, in waves of max_wave from 0; on the sketch path one
    # routing draw per wave (numpy, so it equals the reference's).
    max_level = int(levels.max())
    entry_point = int(np.argmax(levels == max_level))
    if config.refine_passes > 0 and n > 1:
        max_iters = 4 * max(config.ef_construction // config.expand_width, 1) + 16
        rng_r = np.random.default_rng(config.seed ^ 0x0F1E)
        for _ in range(config.refine_passes):
            for s in range(0, n, max_wave):
                sketch_ctx = None
                if use_sketch:
                    routing = torch.as_tensor(rng_r.integers(0, n, size=config.routing_size),
                                              dtype=torch.int32, device=dev)
                    sketch_ctx = (node_sketch, node_proj_q, routing, w, scale)
                wave_body(neighbors, degrees, nbr_sketch, s, entry_point, x_padded, n,
                          sketch_ctx, config=config, wave=max_wave,
                          buffer_width=buffer_width, max_iters=max_iters, refine=True)

    # final sweep: repair any node still over m0, crop slack + padding.
    _final_sweep(neighbors, degrees, nbr_sketch, x_padded, m0, config.metric,
                 config.diversify, w, scale)
    graph = CsrGraph(
        neighbors=neighbors[:n, :m0].contiguous(),
        degrees=degrees[:n].contiguous(),
        levels=to_device(levels, dev),
        entry_point=entry_point,
        max_level=max_level,
    )
    sketch_index = None
    if want_sketch:
        if use_sketch:
            sketch_index = proj_ops.SketchIndex(
                w=w, scale=scale, node_sketch=node_sketch[:n].contiguous(),
                nbr_sketch=nbr_sketch[:n, : m0 * (pdims // proj_ops.PACK)].contiguous())
        elif dim >= proj_ops.PACK:
            sketch_index = proj_ops.build_sketch_index(
                x_prepped, graph.neighbors, proj_dims=pdims, seed=config.seed, w=w)
    return graph, sketch_index


def extend_graph(neighbors0: torch.Tensor, degrees0: torch.Tensor,
                 x_all_prepped: torch.Tensor, n_old: int, config: LeannConfig,
                 entry_point: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Append nodes [n_old, n) to a built graph by insertion waves over the
    FULL prepped corpus x_all_prepped [n, d] (old + new), searching from
    `entry_point` on the exact path. -> (neighbors [n, m0], degrees [n]).

    The waves are the reference's: width min(wave_size, _bucket_size(n_new))
    and its max_iters, which shape the graph. The reference also pads the
    graph and corpus to _bucket_size(n) so that its compiled wave step is
    reused across sizes; padded rows never insert, are never searched and
    stay at degree 0, so the port pads the corpus by one wave only (the
    last wave's slice) and the graph not at all, with equal results."""
    config.validate()
    n = int(x_all_prepped.shape[0])
    m0 = config.m0
    if n - n_old <= 0:
        return neighbors0[:, :m0], degrees0
    dev = x_all_prepped.device
    bw = m0 + config.reverse_slack
    wave = min(config.wave_size, _bucket_size(n - n_old))
    max_iters = 4 * max(config.ef_construction // config.expand_width, 1) + 16

    neighbors = torch.full((n, bw), SENTINEL, dtype=torch.int32, device=dev)
    neighbors[:n_old, :m0] = neighbors0[:, :m0].to(dev)
    degrees = torch.zeros((n,), dtype=torch.int32, device=dev)
    degrees[:n_old] = degrees0.to(dev)
    x_padded = torch.nn.functional.pad(x_all_prepped.float(), (0, 0, 0, wave))
    s = n_old
    while s < n:
        wave_body(neighbors, degrees, None, s, int(entry_point), x_padded, n, None,
                  config=config, wave=wave, buffer_width=bw, max_iters=max_iters)
        s += wave
    _final_sweep(neighbors, degrees, None, x_padded, m0, config.metric, config.diversify)
    return neighbors[:, :m0].contiguous(), degrees
