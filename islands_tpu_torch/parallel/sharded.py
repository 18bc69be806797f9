"""Sharded "archipelago" index: the corpus partitioned over a shard mesh.

Port of islands_tpu/parallel/sharded.py:
- build: each shard builds its own graph over its id range of the corpus
  with the exact-path insertion waves of core/build.py (shards never talk
  during construction, so a loop over this process's shards takes the
  place of shard_map);
- search: every shard searches its own graph for all queries, then the
  per-shard top-k are gathered and merged into a global top-k. Gates
  "exact" (stored rows, entries routed through the sketch when the index
  has one) and "sketch" (two-level gated hop; kernel K1 with
  hop_merge="fused"); a caller's exact scorer and per-shard ctx replace the
  stored rows for recompute (LEANN's graph-only deployment, sharded);
- extend: new vectors spread over the shards emptiest first and appended
  at each shard's tail (the per-repo re-index);
- save/load: the reference's file, byte for byte.

In one process every shard lives on the mesh's device and the merge
concatenates the shards' results; under torch.distributed each rank holds
its one shard, the merge all-gathers [b, k] over the shard axis (then the
slice axis), and with dp > 1 each rank searches its slice of the queries
and the full [B, k] is gathered over dp.

Node identity: each shard keeps `gids [n_local]`, its local -> global id
table, so shards grow independently and global ids stay stable across
extends.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from islands_tpu_torch.core.build import (
    _bucket_size,
    _final_sweep,
    _prefix_entries,
    sample_levels,
    wave_body,
)
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.csr import SENTINEL
from islands_tpu_torch.core.search import (
    batched_search,
    batched_sketch_gated_query,
    make_stored_scorer,
    route_entries,
)
from islands_tpu_torch.core.storage import (
    IndexReader,
    IndexWriter,
    StorageError,
    config_from_dict,
    config_to_dict,
    write_atomic,
)
from islands_tpu_torch.device import to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.ops.merge import smallest_k
from islands_tpu_torch.parallel.mesh import Mesh, make_mesh

_INF = float("inf")


@dataclasses.dataclass
class ShardedIndex:
    """This process's shards, stacked on a leading axis in the order of
    `mesh.local_shards` (all shards in one process), on `mesh.device`.
    `counts` holds every shard's count, on every rank; `entries` the local
    shards' entry points."""

    neighbors: torch.Tensor  # [S_l, n_local, m0] int32
    degrees: torch.Tensor  # [S_l, n_local] int32
    entries: np.ndarray  # [S_l] int32 local entry points
    x_prepped: torch.Tensor  # [S_l, n_local, d] stored (prepped) embeddings
    counts: np.ndarray  # [S] int32 logical vectors per shard
    gids: torch.Tensor  # [S_l, n_local] int32 local -> global id (SENTINEL padding)
    mesh: Mesh
    metric: DistanceMetric
    config: LeannConfig | None = None
    # optional sketch state (the sharded two-level gate)
    sketch_w: torch.Tensor | None = None  # [d, P] shared projection
    sketch_scale: torch.Tensor | None = None  # scalar
    node_sketch: torch.Tensor | None = None  # [S_l, n_local, P/4]
    nbr_sketch: torch.Tensor | None = None  # [S_l, n_local, m0*P/4]
    routing: torch.Tensor | None = None  # [S_l, R] local routing ids

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    @property
    def n_local(self) -> int:
        return self.neighbors.shape[1]

    @property
    def num_vectors(self) -> int:
        return int(np.sum(self.counts))

    @property
    def has_sketch(self) -> bool:
        return self.nbr_sketch is not None


def _owner_rank(mesh: Mesh, shard: int) -> int:
    """The first rank that holds global shard `shard` (its dp slice 0)."""
    return shard * mesh.shape["dp"]


def _sharded_sketch(index: ShardedIndex, proj_dims: int, seed: int, w=None) -> None:
    """Derive every local shard's sketch arrays and routing ids. The scale is
    fitted on the real rows of the first non-empty shard (shard 0 may be
    empty after uneven extends, and padding would dilute the rms); routing
    draws `routing_size` ids per shard from a numpy generator, so they equal
    the reference's."""
    mesh, dev = index.mesh, index.mesh.device
    d = index.x_prepped.shape[-1]
    if w is None:
        w = proj_ops.make_projection(d, proj_dims, seed, dev)
    w = to_device(w, dev, torch.float32)
    counts = index.counts
    nonempty = np.flatnonzero(counts > 0)
    si = int(nonempty[0]) if nonempty.size else 0
    if si in mesh.local_shards:
        c = max(int(counts[si]), 1)
        scale = proj_ops.fit_scale(index.x_prepped[mesh.local_shards.index(si), :c] @ w)
    else:
        scale = torch.zeros((), dtype=torch.float32, device=dev)
    if mesh.distributed:
        dist.broadcast(scale, _owner_rank(mesh, si))
    node = proj_ops.quantize_pack(index.x_prepped @ w, scale)  # [S_l, n_l, P/4]
    nbrs = index.neighbors
    n_l = nbrs.shape[1]
    nbr = torch.stack([node[li][torch.clamp(nbrs[li], 0, n_l - 1).long()]
                       for li in range(nbrs.shape[0])])
    nbr = torch.where((nbrs != SENTINEL)[..., None], nbr, 0)
    rng = np.random.default_rng(seed ^ 0xA5)
    r_size = index.config.routing_size if index.config is not None else 256
    routing = np.stack([rng.integers(0, max(int(c), 1), size=r_size).astype(np.int32)
                        for c in counts])
    index.sketch_w = w
    index.sketch_scale = scale
    index.node_sketch = node
    index.nbr_sketch = nbr.reshape(nbrs.shape[0], n_l, -1)
    index.routing = torch.as_tensor(routing[list(mesh.local_shards)], device=dev)


def _insert_waves(nbrs, degs, xl, count: int, config: LeannConfig, starts, entries,
                  widths) -> None:
    """Exact-path insertion waves on one shard, IN PLACE: wave i inserts
    [starts[i], starts[i] + widths[i]) from entry point entries[i]."""
    max_iters = 4 * max(config.ef_construction // config.expand_width, 1) + 16
    bw = nbrs.shape[1]
    for s, entry, wave in zip(starts, entries, widths):
        wave_body(nbrs, degs, None, int(s), int(entry), xl, count, None, config=config,
                  wave=wave, buffer_width=bw, max_iters=max_iters)


def _build_shard(nbrs, degs, xl, count: int, entries_all, config: LeannConfig,
                 max_wave: int) -> None:
    """One shard's graph, IN PLACE: a brute-force kNN over a seed set of up
    to one wave with padding rows (ids >= count) masked out, the doubling
    wave schedule of the single-graph build, then the final sweep."""
    n_local = nbrs.shape[0]
    m0, metric = config.m0, config.metric
    w0 = min(n_local, max(2 * m0, min(config.wave_size, 4096)))
    k0 = min(m0, w0 - 1)
    if k0 > 0:
        d0 = dist_ops.pairwise_distance(xl[:w0], xl[:w0], metric)
        ids0 = torch.arange(w0, device=xl.device)
        bad = (torch.eye(w0, dtype=torch.bool, device=xl.device)
               | (ids0[None, :] >= count) | (ids0[:, None] >= count))
        d0 = torch.where(bad, _INF, d0)
        pos = smallest_k(d0, k0)  # lax.top_k(-d0, k0)
        ok0 = d0.gather(1, pos) < _INF
        nbrs[:w0, :k0] = torch.where(ok0, pos, SENTINEL).to(torch.int32)
        degs[:w0] = ok0.sum(dim=1, dtype=torch.int32)
    starts, widths = [], []
    s = w0
    while s < n_local:
        starts.append(s)
        widths.append(min(max_wave, 1 << max(8, s.bit_length() - 1)))
        s += widths[-1]
    _insert_waves(nbrs, degs, xl, count, config, starts, entries_all[starts], widths)
    _final_sweep(nbrs, degs, None, xl, m0, metric, config.diversify)


def _extend_shard(nbrs, degs, xl, old_count: int, count: int, entry: int,
                  config: LeannConfig, max_wave: int, n_waves: int) -> None:
    """One shard's append, IN PLACE: `n_waves` waves of `max_wave` from its
    old count, each from its existing entry point, then the final sweep."""
    _insert_waves(nbrs, degs, xl, count, config,
                  [old_count + j * max_wave for j in range(n_waves)], [entry] * n_waves,
                  [max_wave] * n_waves)
    _final_sweep(nbrs, degs, None, xl, config.m0, config.metric, config.diversify)


def build_sharded(x, config: LeannConfig | None = None, mesh: Mesh | None = None,
                  with_sketch: bool | None = None, w=None) -> ShardedIndex:
    """Partition `x` [N, d] by id range over the mesh's shards and build
    each of this process's shards (levels from `seed + shard`; entries the
    max-level real row). `with_sketch` (default: config.sketch_build)
    derives the sketch state for the gated search; `w` [d, P] replaces the
    projection drawn from `config.seed` (tests pass the reference's)."""
    config = config or LeannConfig()
    config.validate()
    mesh = mesh or make_mesh()
    dev = mesh.device
    s_count = mesh.num_shards
    n, d = int(x.shape[0]), int(x.shape[1])
    n_local = max(-(-n // s_count), config.m0 + 2)
    m0 = config.m0
    bw = m0 + config.reverse_slack
    max_wave = min(config.wave_size, n_local)
    counts = np.array([max(min((si + 1) * n_local, n) - si * n_local, 0)
                       for si in range(s_count)], dtype=np.int32)
    s_l = len(mesh.local_shards)
    # Padded by one wave so the last wave's slice never runs short.
    xp = torch.zeros((s_l, n_local + max_wave, d), dtype=torch.float32, device=dev)
    gids = torch.full((s_l, n_local), SENTINEL, dtype=torch.int32, device=dev)
    neighbors = torch.full((s_l, n_local, bw), SENTINEL, dtype=torch.int32, device=dev)
    degrees = torch.zeros((s_l, n_local), dtype=torch.int32, device=dev)
    entries = np.zeros((s_l,), dtype=np.int32)
    for li, si in enumerate(mesh.local_shards):
        lo, c = si * n_local, int(counts[si])
        if c > 0:
            xp[li, :c] = dist_ops.prep_corpus(to_device(x[lo:lo + c], dev, torch.float32),
                                              config.metric)
            gids[li, :c] = torch.arange(lo, lo + c, dtype=torch.int32, device=dev)
        levels = sample_levels(n_local, config.ml, config.max_layers, config.seed + si)
        # Padding rows have no edges and zero vectors: no entry point there.
        masked = levels.copy()
        masked[c:] = -1
        _build_shard(neighbors[li], degrees[li], xp[li], c, _prefix_entries(masked), config,
                     max_wave)
        entries[li] = int(np.argmax(levels[:max(c, 1)]))
    index = ShardedIndex(
        neighbors=neighbors[:, :, :m0].contiguous(), degrees=degrees, entries=entries,
        x_prepped=xp[:, :n_local].contiguous(), counts=counts, gids=gids, mesh=mesh,
        metric=config.metric, config=config)
    if with_sketch is None:
        with_sketch = config.sketch_build
    if with_sketch and d >= proj_ops.PACK:
        pdims = min(config.sketch_dims, d)
        pdims = max(pdims - pdims % proj_ops.PACK, proj_ops.PACK)
        _sharded_sketch(index, pdims, config.seed, w)
    return index


def _global_max(mesh: Mesh, value: int) -> int:
    if not mesh.distributed:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def extend_sharded(index: ShardedIndex, new_x) -> ShardedIndex:
    """Balanced incremental append: new vectors go to the shards emptiest
    first (numpy's argsort order on ties, as the reference), are inserted
    by constant-width exact-path waves at each shard's own tail against its
    existing graph, and take global ids continuing from the current
    maximum. `n_local` grows to the reference's bucketed size, which is
    index data: it is saved in the header and sets the saved shapes."""
    config = index.config or LeannConfig(metric=index.metric)
    if config.m0 != int(index.neighbors.shape[2]):
        raise ValueError(
            f"config.m0={config.m0} does not match the index's max degree "
            f"{int(index.neighbors.shape[2])} (index loaded without its construction config?)")
    mesh, dev = index.mesh, index.mesh.device
    s_count = index.num_shards
    n_new = int(new_x.shape[0])
    if n_new == 0:
        return index
    d = index.x_prepped.shape[-1]
    counts = index.counts.copy()
    old_n_local = index.n_local
    local_max = int(index.gids.max()) if index.gids.numel() else -1
    next_gid = _global_max(mesh, local_max) + 1 if index.num_vectors else 0

    per_shard_new = np.zeros(s_count, dtype=np.int64)
    order = np.argsort(counts)
    base, rem = divmod(n_new, s_count)
    per_shard_new[:] = base
    per_shard_new[order[:rem]] += 1
    n_struct = max(_bucket_size(int(np.max(counts + per_shard_new))), old_n_local)
    m0 = config.m0
    bw = m0 + config.reverse_slack
    new_max = int(per_shard_new.max())
    max_wave = min(config.wave_size, _bucket_size(max(new_max, 1)))

    s_l = len(mesh.local_shards)
    xs = torch.zeros((s_l, n_struct + max_wave, d), dtype=torch.float32, device=dev)
    xs[:, :old_n_local] = index.x_prepped
    gids = torch.full((s_l, n_struct), SENTINEL, dtype=torch.int32, device=dev)
    gids[:, :old_n_local] = index.gids
    new_counts = counts.copy()
    pos = 0
    for si in order:
        take = int(per_shard_new[si])
        if take == 0:
            continue
        c = int(counts[si])
        if si in mesh.local_shards:
            li = mesh.local_shards.index(si)
            xs[li, c:c + take] = dist_ops.prep_corpus(
                to_device(new_x[pos:pos + take], dev, torch.float32), index.metric)
            gids[li, c:c + take] = torch.arange(next_gid + pos, next_gid + pos + take,
                                                dtype=torch.int32, device=dev)
        new_counts[si] = c + take
        pos += take

    neighbors = torch.full((s_l, n_struct, bw), SENTINEL, dtype=torch.int32, device=dev)
    neighbors[:, :old_n_local, :m0] = index.neighbors
    degrees = torch.zeros((s_l, n_struct), dtype=torch.int32, device=dev)
    degrees[:, :old_n_local] = index.degrees
    # Every shard runs the same number of waves (the most any shard needs).
    n_waves = -(-new_max // max_wave)
    for li, si in enumerate(mesh.local_shards):
        _extend_shard(neighbors[li], degrees[li], xs[li], int(counts[si]), int(new_counts[si]),
                      int(index.entries[li]), config, max_wave, n_waves)

    out = ShardedIndex(
        neighbors=neighbors[:, :, :m0].contiguous(), degrees=degrees,
        entries=index.entries.copy(), x_prepped=xs[:, :n_struct].contiguous(),
        counts=new_counts, gids=gids, mesh=mesh, metric=index.metric, config=config)
    if index.has_sketch:
        # The same projection (the reference redraws it from the same seed).
        _sharded_sketch(out, index.sketch_w.shape[1], config.seed, index.sketch_w)
    return out


def _tree_map(fn, tree, specs):
    """fn(leaf, spec) over a tree of tuples and dicts; anything else
    (a tensor, a list, a callable) is a leaf."""
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t, s) for t, s in zip(tree, specs))
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], specs[key]) for key in tree}
    return fn(tree, specs)


class ArchipelagoSearcher:
    """Mesh-wide search: per-shard search plus a gathered top-k merge.

    Gates: "exact" scores every hop exactly over the stored rows (entries
    routed through the sketch when the index has one); "sketch" is the
    two-level gated hop over the inline neighbour sketches, scoring only the
    promoted candidates exactly. For recompute pass `exact_scorer` (such as
    core.search.make_recompute_scorer(metric)) and `exact_ctx`: a tensor or
    list with one entry per local shard, or a tuple or dict of such leaves.
    `ctx_specs` has the same structure, True where a leaf is per shard and
    False where every shard shares it whole (encoder parameters, say); by
    default every leaf is per shard.
    """

    def __init__(self, index: ShardedIndex, exact_scorer=None, exact_ctx=None,
                 ctx_specs=None):
        self.index = index
        self.exact_scorer = exact_scorer or make_stored_scorer(index.metric)
        self.exact_ctx = exact_ctx if exact_ctx is not None else index.x_prepped
        self.ctx_specs = (ctx_specs if ctx_specs is not None
                          else _tree_map(lambda leaf, spec: True, self.exact_ctx, self.exact_ctx))

    def _shard_ctx(self, li: int):
        return _tree_map(lambda leaf, sharded: leaf[li] if sharded else leaf,
                         self.exact_ctx, self.ctx_specs)

    def search(self, queries, k: int = 10, ef: int = 64, expand_width: int = 4,
               max_iters: int | None = None, gate: str = "auto",
               promote_width: int | None = None, static_loop: bool = False,
               final_rescore: int = 0, hop_merge: str = "inline"):
        """queries [B, d] -> (dists [B, k], ids [B, k]) with global ids,
        ascending; unfilled slots (+inf, SENTINEL). B must be divisible by
        the mesh's dp size. The knobs are the reference's: `promote_width`
        caps each hop's exact scoring per shard, `static_loop` runs exactly
        `max_iters` hops, `final_rescore` rescores that many AQ heads per
        shard before the merge, and `hop_merge` is "inline" or "fused"
        (kernel K1). `max_iters` defaults to config.max_search_iters, then
        to the gate's own formula."""
        mesh = self.index.mesh
        d, i = self.search_shards(queries, k, ef, expand_width, max_iters, gate, promote_width,
                                  static_loop, final_rescore, hop_merge)
        counts = torch.as_tensor(self.index.counts[list(mesh.local_shards)], device=mesh.device)
        d, i = _merge_topk(d, i, self.index.gids, counts, k, mesh)
        if mesh.distributed and mesh.shape["dp"] > 1:
            d, i = (torch.cat(_all_gather(t, mesh.groups["dp"])) for t in (d, i))
        return d, i

    def search_shards(self, queries, k: int = 10, ef: int = 64, expand_width: int = 4,
                      max_iters: int | None = None, gate: str = "auto",
                      promote_width: int | None = None, static_loop: bool = False,
                      final_rescore: int = 0, hop_merge: str = "inline"):
        """Each local shard's own search, before the merge: (dists
        [S_l, b, k], local ids [S_l, b, k]), b this rank's share of the
        queries. `search`'s knobs."""
        idx = self.index
        mesh = idx.mesh
        ef = max(ef, k)
        if gate == "auto":
            gate = "sketch" if idx.has_sketch else "exact"
        if gate not in ("exact", "sketch"):
            raise ValueError(f"unknown gate {gate!r}: 'auto', 'exact' or 'sketch'")
        if gate == "sketch" and not idx.has_sketch:
            raise ValueError("index has no sketch state (gate='sketch')")
        promote = promote_width or max(8, min(2 * expand_width * 4, ef))
        if max_iters is None and idx.config is not None:
            max_iters = idx.config.max_search_iters
        if max_iters is None:
            max_iters = (8 * max(ef // promote, 1) + 32 if gate == "sketch"
                         else 4 * max(ef // max(expand_width, 1), 1) + 16)
        qp = dist_ops.prep_query(to_device(queries, mesh.device, torch.float32), idx.metric)
        b, n_dp = qp.shape[0], mesh.shape["dp"]
        if b % n_dp:
            raise ValueError(f"{b} queries do not split over dp = {n_dp}")
        if mesh.distributed and n_dp > 1:
            part = b // n_dp
            qp = qp[mesh.dp_index * part:(mesh.dp_index + 1) * part]
        qs = (proj_ops.sketch_query(qp, idx.sketch_w, idx.sketch_scale)
              if idx.has_sketch else None)
        d_loc, i_loc = [], []
        for li in range(len(mesh.local_shards)):
            ctx = self._shard_ctx(li)
            if gate == "sketch":
                d, i, _ = batched_sketch_gated_query(
                    qp, qs, ctx, idx.sketch_scale, idx.neighbors[li], idx.nbr_sketch[li],
                    idx.node_sketch[li], idx.routing[li], exact_scorer=self.exact_scorer,
                    metric=idx.metric, dim=int(qp.shape[1]), ef=ef, k=k,
                    aq_width=max(ef, 64), promote_width=promote, expand_width=expand_width,
                    max_iters=max_iters, static_iters=static_loop,
                    final_rescore=final_rescore, hop_merge_mode=hop_merge)
            else:
                entry = (route_entries(qs, idx.routing[li], idx.node_sketch[li], idx.metric)
                         if idx.has_sketch else int(idx.entries[li]))
                d, i = batched_search(qp, ctx, idx.neighbors[li], entry,
                                      scorer=self.exact_scorer, ef=ef,
                                      expand_width=expand_width, max_iters=max_iters)
            d_loc.append(d[:, :k])
            i_loc.append(i[:, :k])
        return torch.stack(d_loc), torch.stack(i_loc)


def _all_gather(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _merge_axis(d: torch.Tensor, i: torch.Tensor, k: int):
    """[..., A, b, k] -> the best k of each query over A, [..., b, k]: the
    flatten is A-major per query (the reference's transpose(1, 0, 2)) and
    the top-k puts the lower position first on ties (lax.top_k)."""
    *lead, a, b, kk = d.shape
    dflat = d.movedim(-3, -2).reshape(*lead, b, a * kk)
    iflat = i.movedim(-3, -2).reshape(*lead, b, a * kk)
    pos = smallest_k(dflat, k)
    return dflat.gather(-1, pos), iflat.gather(-1, pos)


def _merge_topk(d_loc, i_loc, gids, counts, k: int, mesh: Mesh):
    """Mask padding and unfilled slots to (+inf, SENTINEL), map local ids to
    global ones, then merge: over 'shards' first and, on a multislice mesh,
    over 'slice' after (the reference's two-step merge; it can order ties
    differently from one flat merge). d_loc, i_loc [S_l, b, >=k]; counts
    [S_l] the local shards' counts."""
    d_loc, i_loc = d_loc[..., :k], i_loc[..., :k]
    valid = (i_loc >= 0) & (i_loc < counts[:, None, None])
    d = torch.where(valid, d_loc, _INF)
    s_l, b, _ = i_loc.shape
    safe = torch.clamp(i_loc, 0, gids.shape[1] - 1).long().reshape(s_l, -1)
    i = torch.where(valid, gids.gather(1, safe).reshape(i_loc.shape), SENTINEL)
    axes = ("shards", "slice") if "slice" in mesh.axis_names else ("shards",)
    if mesh.distributed:
        d, i = d[0], i[0]
        for ax in axes:
            group = mesh.groups[ax]
            d, i = _merge_axis(torch.stack(_all_gather(d, group)),
                               torch.stack(_all_gather(i, group)), k)
        return d, i
    if "slice" in mesh.axis_names:
        shape = (mesh.shape["slice"], mesh.shape["shards"], b, k)
        d, i = _merge_axis(d.reshape(shape), i.reshape(shape), k)  # [slices, b, k]
    return _merge_axis(d, i, k)


# ---------------------------------------------------------------------------
# Persistence (the reference's tagged-chunk container and header)
# ---------------------------------------------------------------------------


def save_sharded(index: ShardedIndex, path) -> int:
    """Serialize a ShardedIndex (graphs, corpus, gids, sketch state) in one
    process that holds every shard. The mesh is not stored: pass one at
    load time. -> bytes written."""
    if index.mesh.distributed:
        raise ValueError("save_sharded needs every shard in one process")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    w = IndexWriter(buf)
    header = {
        "version": 1,
        "num_shards": index.num_shards,
        "n_local": index.n_local,
        "m0": int(index.neighbors.shape[2]),
        "dim": int(index.x_prepped.shape[-1]),
        "metric": index.metric.value,
        "has_sketch": bool(index.has_sketch),
    }
    if index.config is not None:
        header["config"] = config_to_dict(index.config)
    w.write_chunk(b"SHRD", json.dumps(header).encode())

    def arr_chunk(tag, a, dt):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        w.write_chunk(tag, np.ascontiguousarray(a, dtype=dt).tobytes())

    arr_chunk(b"NBRS", index.neighbors, "<i4")
    arr_chunk(b"DEGS", index.degrees, "<i4")
    arr_chunk(b"ENTR", index.entries, "<i4")
    arr_chunk(b"CNTS", index.counts, "<i4")
    arr_chunk(b"GIDS", index.gids, "<i4")
    arr_chunk(b"EMBS", index.x_prepped, "<f4")
    if index.has_sketch:
        arr_chunk(b"SKW_", index.sketch_w, "<f4")
        w.write_chunk(b"SKSC", struct.pack("<f", float(index.sketch_scale)))
        arr_chunk(b"SKND", index.node_sketch, "<i4")
        arr_chunk(b"SKNB", index.nbr_sketch, "<i4")
        arr_chunk(b"SKRT", index.routing, "<i4")
    return write_atomic(path, buf.getvalue())


def sharded_from_numpy(mesh: Mesh, metric: DistanceMetric, config: LeannConfig | None,
                       neighbors, degrees, entries, x_prepped, counts, gids,
                       sketch: dict | None = None) -> ShardedIndex:
    """A ShardedIndex from every shard's arrays as numpy ([S, ...], such as
    a reference ShardedIndex's fields or a saved file's chunks): the mesh's
    local shards go to its device. `sketch` holds (w, scale, node_sketch,
    nbr_sketch, routing) by name."""
    dev, local = mesh.device, list(mesh.local_shards)
    counts = np.asarray(counts, dtype=np.int32)
    if len(counts) != mesh.num_shards:
        raise ValueError(f"arrays hold {len(counts)} shards, mesh has {mesh.num_shards}")

    def part(a, dtype):
        return to_device(np.asarray(a)[local], dev, dtype)

    index = ShardedIndex(
        neighbors=part(neighbors, torch.int32), degrees=part(degrees, torch.int32),
        entries=np.asarray(entries, dtype=np.int32)[local].copy(),
        x_prepped=part(x_prepped, torch.float32), counts=counts.copy(),
        gids=part(gids, torch.int32), mesh=mesh, metric=metric, config=config)
    if sketch is not None:
        index.sketch_w = to_device(sketch["w"], dev, torch.float32)
        index.sketch_scale = to_device(np.float32(sketch["scale"]), dev, torch.float32)
        index.node_sketch = part(sketch["node_sketch"], torch.int32)
        index.nbr_sketch = part(sketch["nbr_sketch"], torch.int32)
        index.routing = part(sketch["routing"], torch.int32)
    return index


def load_sharded(path, mesh: Mesh | None = None) -> ShardedIndex:
    """Load a ShardedIndex onto `mesh`, whose shard count must match the
    file's (StorageError otherwise); the default mesh is one process with
    the file's shard count on the default device."""
    chunks = IndexReader(io.BytesIO(Path(path).read_bytes())).read_all()
    if b"SHRD" not in chunks:
        raise StorageError("missing SHRD header chunk")
    h = json.loads(chunks[b"SHRD"])
    s, n_l, m0, d = h["num_shards"], h["n_local"], h["m0"], h["dim"]
    mesh = mesh or make_mesh(n_shards=s)
    if mesh.num_shards != s:
        raise StorageError(f"index has {s} shards, mesh has {mesh.num_shards}")

    def arr(tag, dt, shape):
        return np.frombuffer(chunks[tag], dtype=dt).reshape(shape)

    config = config_from_dict(h["config"], LeannConfig) if h.get("config") else None
    sketch = None
    if h.get("has_sketch"):
        wmat = arr(b"SKW_", "<f4", (d, -1))
        p4 = wmat.shape[1] // proj_ops.PACK
        sketch = dict(w=wmat, scale=struct.unpack("<f", chunks[b"SKSC"])[0],
                      node_sketch=arr(b"SKND", "<i4", (s, n_l, p4)),
                      nbr_sketch=arr(b"SKNB", "<i4", (s, n_l, m0 * p4)),
                      routing=arr(b"SKRT", "<i4", (s, -1)))
    return sharded_from_numpy(
        mesh, DistanceMetric(h["metric"]), config, arr(b"NBRS", "<i4", (s, n_l, m0)),
        arr(b"DEGS", "<i4", (s, n_l)), arr(b"ENTR", "<i4", (s,)), arr(b"EMBS", "<f4", (s, n_l, d)),
        arr(b"CNTS", "<i4", (s,)), arr(b"GIDS", "<i4", (s, n_l)), sketch)
