"""Graph construction of the PyTorch port against the JAX package.

With the reference's projection `w` and the same numpy levels, the port's
build_index_with_sketch must give a graph that satisfies the invariants of
tests/test_build.py and whose recall@10 lies within +-0.01 of the JAX-built
graph's (both searched by the same searcher). The wave pieces whose inputs
are given (reverse-edge scatter, neighbour selection) must match exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islands_tpu.core import build as jbuild
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu_torch import testing
from islands_tpu_torch.convert import graph_from_numpy
from islands_tpu_torch.core import build as tbuild
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.ops import distance as td

from conftest import make_vectors

SMALL = dict(m=8, m0=16, ef_construction=48, ef_search=48, wave_size=128,
             intra_wave_k=8, reverse_slack=16)


def graph_invariants(nbrs, degs, n, m0):
    """tests/test_build.py's invariants on an [n, m0] graph."""
    assert nbrs.shape == (n, m0)
    testing.graph_invariants(nbrs, degs, n)


def _recall(graph, x, q, metric):
    _, ids = StoredSearcher(graph, x, metric, device="cpu").search(q, k=10, ef=64)
    _, tids = td.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10, metric)
    ids, tids = ids.numpy(), tids.numpy()
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(ids, tids)])


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_build_matches_reference_recall(metric):
    n, dim = 600, 32
    x = make_vectors(n, dim, seed=20)
    q = make_vectors(32, dim, seed=21)
    jcfg = JConfig(metric=JM(metric), **SMALL)
    levels = jbuild.sample_levels(n, jcfg.ml, jcfg.max_layers, jcfg.seed)
    jg, js = jbuild.build_index_with_sketch(x, jcfg, levels)
    assert js is not None and js.nbr_sketch.shape[1] == 16 * 4  # sketch path taken
    g, sk = tbuild.build_index_with_sketch(x, TConfig(metric=TM(metric), **SMALL), levels,
                                           w=np.asarray(js.w), device="cpu")
    nbrs, degs = g.neighbors.numpy(), g.degrees.numpy()
    graph_invariants(nbrs, degs, n, 16)
    g.validate()
    assert (g.entry_point, g.max_level) == (int(jg.entry_point), int(jg.max_level))
    ref = graph_from_numpy(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                           np.asarray(jg.levels), int(jg.entry_point),
                           int(jg.max_level), device="cpu")
    r_port, r_ref = _recall(g, x, q, TM(metric)), _recall(ref, x, q, TM(metric))
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert r_port >= 0.85
    # The sketch kept during the build is row-aligned with the final graph.
    np.testing.assert_array_equal(sk.node_sketch.numpy(), np.asarray(js.node_sketch))
    assert sk.nbr_sketch.shape == tuple(js.nbr_sketch.shape)


def test_levels_and_prefix_entries_match():
    jl = jbuild.sample_levels(5000, 1.0 / np.log(30.0), 16, seed=1)
    tl = tbuild.sample_levels(5000, 1.0 / np.log(30.0), 16, seed=1)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tbuild._prefix_entries(tl), jbuild._prefix_entries(jl))


@pytest.mark.parametrize("n", [1, 500, 1_000_000, 1_250_000, 2_200_000])
def test_bucket_size_matches(n):
    assert tbuild._bucket_size(n) == jbuild._bucket_size(n)


@pytest.mark.parametrize("with_sketch", [False, True])
def test_scatter_reverse_edges_exact(with_sketch):
    rng = np.random.default_rng(7)
    n, bw, p4, m0, wavew = 64, 12, 4, 8, 16
    degs = rng.integers(0, 6, n).astype(np.int32)
    nbrs = np.full((n, bw), -1, np.int32)
    for i in range(n):
        nbrs[i, :degs[i]] = rng.integers(0, n, degs[i])
    nbr_sketch = rng.integers(-(2**30), 2**30, (n, bw * p4)).astype(np.int32)
    node_sketch = rng.integers(-(2**30), 2**30, (n, p4)).astype(np.int32)
    sel_ids = rng.integers(0, n, (wavew, m0)).astype(np.int32)
    sel_d = rng.integers(0, 4, (wavew, m0)).astype(np.float32)  # ties on purpose
    src = np.broadcast_to(np.arange(wavew, dtype=np.int32)[:, None], (wavew, m0)).copy()
    valid = rng.random((wavew, m0)) < 0.9
    sk = (nbr_sketch, node_sketch) if with_sketch else (None, None)
    want = jbuild._scatter_reverse_edges(
        *map(jnp.asarray, (nbrs, degs, sel_ids, sel_d, src, valid)),
        *(None if a is None else jnp.asarray(a) for a in sk))
    got = [torch.from_numpy(a.copy()) for a in (nbrs, degs)]
    got_sk = torch.from_numpy(nbr_sketch.copy()) if with_sketch else None
    tbuild._scatter_reverse_edges(got[0], got[1], *map(torch.from_numpy, (sel_ids, sel_d, src, valid)),
                                  got_sk, torch.from_numpy(node_sketch) if with_sketch else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if with_sketch:
        np.testing.assert_array_equal(got_sk.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("diversify,hubs", [(False, True), (True, True), (True, False)])
def test_select_neighbors_exact(diversify, hubs):
    rng = np.random.default_rng(11)
    w, c, d, n, m0 = 24, 30, 8, 200, 12
    cand_ids = rng.integers(0, n, (w, c)).astype(np.int32)
    cand_ids[:, -3:] = -1
    cand_d = np.sort(rng.random((w, c)).astype(np.float32), axis=1)
    cand_d[:, -3:] = np.inf
    emb = (rng.random((w, c, d), dtype=np.float32) * 2 - 1)
    degrees = rng.integers(0, 40, n).astype(np.int32)
    kw = dict(m0=m0, hub_percentile=0.1, high_degree_pruning=hubs, diversify=diversify,
              metric=JM.EUCLIDEAN)
    sel = jax.vmap(lambda a, b, e: jbuild._select_neighbors(
        a, b, e, jnp.asarray(degrees), **kw))
    wi, wd = sel(jnp.asarray(cand_ids), jnp.asarray(cand_d), jnp.asarray(emb))
    ti, tdist = tbuild._select_neighbors(
        torch.from_numpy(cand_ids), torch.from_numpy(cand_d), torch.from_numpy(emb),
        torch.from_numpy(degrees), **dict(kw, metric=TM.EUCLIDEAN))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(wd))


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_small_and_edge_sizes(n):
    x = make_vectors(n, 8, seed=23 + n)
    g = tbuild.build_index(x, TConfig(**dict(SMALL, wave_size=8)), device="cpu")
    graph_invariants(g.neighbors.numpy(), g.degrees.numpy(), n, 16)
    if n > 1:
        assert int(g.degrees.min()) >= 1


def test_empty_and_unported_options():
    g = tbuild.build_index(np.zeros((0, 8), np.float32), TConfig(**SMALL), device="cpu")
    assert g.num_nodes == 0
    # refine_passes > 0 is ported: the refined graph keeps the invariants.
    g = tbuild.build_index(make_vectors(50, 8), TConfig(**SMALL, refine_passes=1),
                           device="cpu")
    graph_invariants(g.neighbors.numpy(), g.degrees.numpy(), 50, 16)


def test_refine_no_duplicate_edges_at_low_degree():
    """tests/test_build.py's case: refine re-scatters reverse edges of nodes
    whose edges exist, and rows that stay at degree <= m0 are never
    repaired, so without the refine-mode mask they would keep duplicate
    ids. A large m0 against n keeps most rows under m0."""
    n = 220
    cfg = TConfig(**dict(SMALL, m0=32, reverse_slack=24, refine_passes=1))
    g = tbuild.build_index(make_vectors(n, 16, seed=41), cfg, device="cpu")
    graph_invariants(g.neighbors.numpy(), g.degrees.numpy(), n, 32)


@pytest.mark.parametrize("defect", ["self", "duplicate", "out_of_range", "stale_slot",
                                    "padding_edge", "over_degree"])
def test_graph_invariants_catch_broken_graphs(defect):
    """The shared checker passes a real graph and rejects each kind of break."""
    n = 40
    g = tbuild.build_index(make_vectors(n, 8, seed=42), TConfig(**SMALL), device="cpu")
    nbrs, degs = g.neighbors.clone(), g.degrees.clone()
    testing.graph_invariants(nbrs, degs, n)
    r = int(torch.argmax(degs))
    d = int(degs[r])
    if defect == "self":
        nbrs[r, 0] = r
    elif defect == "duplicate":
        nbrs[r, 1] = nbrs[r, 0]
    elif defect == "out_of_range":
        nbrs[r, 0] = n
    elif defect == "stale_slot":
        degs[r] = d - 1
    elif defect == "padding_edge":
        n -= 1  # the last row becomes padding, and it keeps its edges
    else:
        degs[r] = nbrs.shape[1] + 1
    with pytest.raises(AssertionError):
        testing.graph_invariants(nbrs, degs, n)


@pytest.mark.parametrize("sketch_build", [False, True])
def test_refined_build_matches_reference_recall(sketch_build):
    """One refine pass on the exact and on the sketch path (one routing draw
    per wave): the invariants, the reference's refined graph edge for edge
    (so the stable id-only dedup and the reverse-edge mask hold), one that
    differs from the unrefined graph, and recall@10 within +-0.01."""
    n, dim = 600, 32
    x = make_vectors(n, dim, seed=20)
    q = make_vectors(32, dim, seed=21)
    kw = dict(SMALL, refine_passes=1, sketch_build=sketch_build, metric="euclidean")
    jcfg = JConfig(**dict(kw, metric=JM.EUCLIDEAN))
    levels = jbuild.sample_levels(n, jcfg.ml, jcfg.max_layers, jcfg.seed)
    jg, js = jbuild.build_index_with_sketch(x, jcfg, levels)
    g, _ = tbuild.build_index_with_sketch(x, TConfig(**dict(kw, metric=TM.EUCLIDEAN)), levels,
                                          w=np.asarray(js.w), device="cpu")
    graph_invariants(g.neighbors.numpy(), g.degrees.numpy(), n, 16)
    np.testing.assert_array_equal(g.neighbors.numpy(), np.asarray(jg.neighbors))
    np.testing.assert_array_equal(g.degrees.numpy(), np.asarray(jg.degrees))
    g0, _ = tbuild.build_index_with_sketch(
        x, TConfig(**dict(kw, refine_passes=0, metric=TM.EUCLIDEAN)), levels,
        w=np.asarray(js.w), device="cpu")
    assert (g0.neighbors != g.neighbors).any(dim=1).float().mean() > 0.5
    ref = graph_from_numpy(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                           np.asarray(jg.levels), int(jg.entry_point), int(jg.max_level),
                           device="cpu")
    r_port, r_ref = _recall(g, x, q, TM.EUCLIDEAN), _recall(ref, x, q, TM.EUCLIDEAN)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert r_port >= 0.85
