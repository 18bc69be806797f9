"""Checks shared by the tests and chip_smoke.py: the build's graph
invariants and a host merge of per-shard top-k results."""

from __future__ import annotations

import numpy as np
import torch


def graph_invariants(nbrs, degs, count: int, what: str = "graph") -> None:
    """tests/test_build.py's invariants, on a CPU or CUDA tensor or a numpy
    array: degree <= m0 (the row width), live slots in [0, count) with no
    self edge or duplicate, SENTINEL (-1) past the degree, and rows from
    `count` on (a shard's padding) without edges. Raises AssertionError."""
    nbrs, degs = torch.as_tensor(nbrs), torch.as_tensor(degs).long()
    rows, m0 = nbrs.shape
    live = torch.arange(m0, device=nbrs.device)[None, :] < degs[:, None]
    row_ids = torch.arange(rows, device=nbrs.device)
    ok = (bool((degs <= m0).all()) and bool((degs[count:] == 0).all())
          and bool(((nbrs >= 0) & (nbrs < count))[live].all())
          and bool((nbrs[~live] == -1).all()) and not bool((nbrs == row_ids[:, None])[live].any()))
    # Dead slots get distinct ids >= count, so a sorted row repeats only live ids.
    srt = torch.sort(torch.where(live, nbrs.long(), count + torch.arange(m0, device=nbrs.device)),
                     dim=1).values
    if not ok or bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{what}: the graph breaks the build invariants")


def host_merge(d_loc, i_loc, gids, counts, k: int):
    """The archipelago's merge in numpy: each query's valid per-shard results
    ([S, B, k] local ids) under their global ids, ordered by distance and, on
    ties, by shard-major position (a stable sort); the first k, as (d, ids)."""
    d_loc, i_loc, gids = (t.cpu().numpy() for t in (d_loc, i_loc, gids))
    counts = np.asarray(counts)
    s, b, kk = d_loc.shape
    valid = (i_loc >= 0) & (i_loc < counts[:, None, None])
    safe = np.clip(i_loc, 0, gids.shape[1] - 1).reshape(s, -1)
    g = np.where(valid, np.take_along_axis(gids, safe, 1).reshape(s, b, kk), -1)
    dflat = np.where(valid, d_loc, np.inf).transpose(1, 0, 2).reshape(b, s * kk)
    gflat = g.transpose(1, 0, 2).reshape(b, s * kk)
    order = np.argsort(dflat, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dflat, order, 1), np.take_along_axis(gflat, order, 1)
